"""PyTorch port, the mesh layer (parallel/sharding.py over
torch.distributed), in gloo CPU ranks against the JAX package on its 8
virtual CPU devices (tests/conftest.py).

The port runs in ranks spawned once per world (a module-scoped fixture
runs every job of the world, each spawn bounded by its own time limit);
its rank functions are ``tests/torch_mesh_workers.py``. The JAX side runs
here. Held:

- ``make_sharded_full_step`` at meshes (4 ranks, stripe 2), (2, 1) and
  (2, 2) on ``tests/test_parallel.py``'s ``_example`` (B = 4, hb = 8,
  wb = 16; at stripe 2 each DC chain crosses a stripe boundary): all three
  outputs exactly JAX's ``make_sharded_full_step(make_mesh(n, stripe))``
  and the port's own single-device step;
- ``decode_rgb_sharded`` over 4 stripes of synthetic images: the v2 wire,
  the v1 wire (``JPX_WIRE=1``), progressive (the host copy's
  ``encode_progressive_rgb``), arithmetic (``transcode(mode="arithmetic")``)
  and lossless (``encode_lossless``), against JAX's over its 4-stripe
  mesh: the DCT modes within 1 LSB on < 1e-4 of the values
  (tests/test_parallel.py:113-122), lossless exactly; the image is 5 MCU
  rows, so the last of the 4 stripes is padding;
- ``mesh_symbol_frequencies`` of 97 blocks (which 4 and 2 do not divide)
  exactly JAX's and the host gather;
- ``batched_transform_rgb(mesh=)`` and ``decode_batch_rgb(mesh=)`` (5
  images, padded over 4 ranks) exactly their single-device results;
- an optimize-coding encode with the mesh on the encoder, host and device
  encode: the bytes of JAX's encoder with a mesh and of the encode
  without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jpeglibrary_tpu.models.encoder import _configure_rgb_encoder as ref_configure
from jpeglibrary_tpu.parallel import sharding as ref_sharding
from jpeglibrary_tpu.syntax.quantization import (
    STANDARD_CHROMINANCE_ZIGZAG,
    STANDARD_LUMINANCE_ZIGZAG,
)

import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu_torch.host.models.lossless import encode_lossless
from jpeglibrary_tpu_torch.host.models.progressive_encoder import encode_progressive_rgb
from jpeglibrary_tpu_torch.host.models.transcode import transcode
from jpeglibrary_tpu_torch.host.ops import encode_stage as host_encode_stage
from jpeglibrary_tpu_torch.parallel import distributed, sharding

import torch_mesh_workers as workers

SPAWN_TIMEOUT = 120.0  # each world's own limit, so a hung rendezvous fails its tests alone


def _example(batch=4, hb=8, wb=16):
    """tests/test_parallel.py's ``_example``."""
    rng = np.random.default_rng(7)
    y = rng.integers(-128, 128, size=(batch, hb, wb, 64), dtype=np.int16)
    cb = rng.integers(-64, 64, size=(batch, hb // 2, wb // 2, 64), dtype=np.int16)
    cr = rng.integers(-64, 64, size=(batch, hb // 2, wb // 2, 64), dtype=np.int16)
    return (y, cb, cr, STANDARD_LUMINANCE_ZIGZAG.astype(np.int32),
            STANDARD_CHROMINANCE_ZIGZAG.astype(np.int32))


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 255, w)[None, :, None]
    return np.clip(ramp + rng.normal(0, 14, (h, w, 3)), 0, 255).astype(np.uint8)


def _stripe_cases():
    """(name, JPEG, v1 wire) of each mode; 80 rows are 5 MCU rows at 4:2:0."""
    img = _image(80, 96, 3)
    baseline = jtt.encode_rgb(img, 85, device="cpu")
    return [("v2", baseline, False), ("v1", baseline, True),
            ("progressive", encode_progressive_rgb(img, 85), False),
            ("arithmetic", transcode(baseline, mode="arithmetic"), False),
            ("lossless", encode_lossless(img, predictor=1), False)]


def _blocks():
    rng = np.random.default_rng(3)
    return rng.integers(-300, 300, size=(97, 64)).astype(np.int16)


def _batch_inputs():
    """4 copies of one image's coefficient planes, and 5 JPEGs of two
    geometries (3 of one, so the group pads over 4 ranks)."""
    r = jtt.decode(jtt.encode_rgb(_image(48, 64, 5), 80, device="cpu"))
    coeffs = [tuple(r.coefficients[c.component_index] for c in r.geometry.components)] * 4
    quants = tuple(r.quant[c.component_index].astype(np.int32) for c in r.geometry.components)
    datas = [jtt.encode_rgb(_image(48, 64, 10 + i), 60 + 10 * i, device="cpu") for i in range(3)]
    datas += [jtt.encode_rgb(_image(32, 40, 20 + i), 75, device="cpu") for i in range(2)]
    return coeffs, quants, r.geometry, datas


ENCODE_IMAGE = (64, 80, 9)
MESH_SHAPES_FREQ = [(4, 1), (4, 2)]


@pytest.fixture(scope="module")
def world4():
    coeffs, quants, geometry, datas = _batch_inputs()
    jobs = [("sharded_steps", ([(4, 2)], _example())),
            ("stripe_decodes", ((4, 4), _stripe_cases())),
            ("symbol_frequencies", (MESH_SHAPES_FREQ, _blocks())),
            ("batches", ((4, 1), coeffs, quants, geometry, datas)),
            ("mesh_encodes", ((4, 1), _image(*ENCODE_IMAGE), 75))]
    ranks = distributed.spawn(workers.run, 4, jobs, backend="gloo", timeout=SPAWN_TIMEOUT)
    return {name: [r[i] for r in ranks] for i, (name, _) in enumerate(jobs)}


@pytest.fixture(scope="module")
def world2():
    ranks = distributed.spawn(workers.sharded_steps, 2, [(2, 1), (2, 2)], _example(),
                              backend="gloo", timeout=SPAWN_TIMEOUT)
    return ranks


@pytest.mark.parametrize("world,n,stripe", [(4, 4, 2), (2, 2, 1), (2, 2, 2)])
def test_sharded_full_step_matches_jax(request, world, n, stripe):
    args = _example()
    ranks = (request.getfixturevalue("world4")["sharded_steps"] if world == 4
             else request.getfixturevalue("world2"))
    want = [np.asarray(x) for x in ref_sharding.make_sharded_full_step(
        ref_sharding.make_mesh(n, stripe=stripe))(*args)]
    single = [x.numpy() for x in sharding.full_step(*args, device="cpu")]
    b, hb = args[0].shape[:2]
    for rank in ranks:
        got = rank[(n, stripe)]
        assert got["local_rgb"] == (b // (n // stripe), hb // stripe * 8, 128, 3)
        assert got["launches"] == (0, 0)  # CPU ranks take the plain versions
        for g, w, s in zip(got["outputs"], want, single):
            assert g.dtype == s.dtype
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("name", ["v2", "v1", "progressive", "arithmetic", "lossless"])
def test_decode_rgb_sharded_matches_jax(world4, monkeypatch, name):
    case = {c[0]: c for c in _stripe_cases()}[name]
    if case[2]:
        monkeypatch.setenv("JPX_WIRE", "1")
    out, heights = ref_sharding.decode_rgb_sharded(case[1], ref_sharding.make_mesh(4, stripe=4))
    want = ref_sharding.assemble_stripes(out, heights)
    for rank in world4["stripe_decodes"]:
        got = rank[name]
        assert got["heights"] == heights and got["local"] == (1,) + out.shape[1:]
        assert got["rgb"].shape == want.shape == (3, 80, 96)
        if name == "lossless":
            np.testing.assert_array_equal(got["rgb"], want)
        else:
            d = np.abs(got["rgb"].astype(np.int64) - want)
            assert d.max() <= 1 and (d > 0).mean() < 1e-4, (d.max(), (d > 0).mean())
    if name != "lossless":  # 5 MCU rows over 4 stripes: the last is padding
        assert heights[-1] == 0


@pytest.mark.parametrize("shape", MESH_SHAPES_FREQ)
def test_mesh_symbol_frequencies_match_jax_and_host(world4, shape):
    blocks = _blocks()
    want = ref_sharding.mesh_symbol_frequencies(blocks, ref_sharding.make_mesh(4, stripe=1))
    host = host_encode_stage.dc_ac_symbol_frequencies(blocks)
    for rank in world4["symbol_frequencies"]:
        for got, w, h in zip(rank[shape], want, host):
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, w)
            np.testing.assert_array_equal(got, h)


def test_batched_transform_rgb_mesh_matches_single_device(world4):
    coeffs, quants, geometry, _ = _batch_inputs()
    want = sharding.batched_transform_rgb(coeffs, quants, geometry, device="cpu").numpy()
    for rank in world4["batches"]:
        np.testing.assert_array_equal(rank["transform"], want)


def test_decode_batch_rgb_mesh_matches_single_device(world4):
    datas = _batch_inputs()[3]
    want = jtt.decode_batch_rgb(datas, device="cpu")
    for rank in world4["batches"]:
        assert len(rank["decode"]) == len(want)
        for got, w in zip(rank["decode"], want):
            np.testing.assert_array_equal(got, w)


def _ref_encode(mesh):
    encoder = ref_configure(75, "420", optimize_coding=True)
    encoder.set_input_rgb(_image(*ENCODE_IMAGE))
    encoder.mesh = mesh
    return encoder.encode()


def test_encoder_mesh_bytes_match_jax(world4):
    want = _ref_encode(ref_sharding.make_mesh(8, stripe=1))
    assert want == _ref_encode(None)
    for rank in world4["mesh_encodes"]:
        assert rank["host"] == want
        assert rank["device"] == want


def test_make_mesh_raises_without_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        sharding.make_mesh(2, device_type="cpu")


@pytest.mark.parametrize("entry", ["decode_batch_rgb", "batched_transform_rgb"])
def test_entry_points_raise_without_device_or_mesh(entry, monkeypatch):
    """``batched_transform_rgb`` needs one of the two. ``decode_batch_rgb``
    takes the card then, as the JAX package takes its default device, and
    without a card it raises, naming ``device="cpu"``: no CPU fallback."""
    if entry == "decode_batch_rgb":
        data = jtt.encode_rgb(_image(16, 16, 1), 75, device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            jtt.decode_batch_rgb([data])
    else:
        with pytest.raises(ValueError, match="device or a mesh"):
            coeffs, quants, geometry, _ = _batch_inputs()
            sharding.batched_transform_rgb(coeffs, quants, geometry)


@pytest.mark.parametrize("entry", ["decode_batch_rgb", "batched_transform_rgb"])
def test_entry_points_raise_on_device_and_mesh(entry):
    """A mesh runs on each rank's own device: a ``device`` given besides
    raises rather than being overridden."""
    mesh = object()  # refused before the mesh is looked at
    with pytest.raises(ValueError, match="not both"):
        if entry == "decode_batch_rgb":
            jtt.decode_batch_rgb([jtt.encode_rgb(_image(16, 16, 1), 75, device="cpu")],
                                 device="cpu", mesh=mesh)
        else:
            coeffs, quants, geometry, _ = _batch_inputs()
            sharding.batched_transform_rgb(coeffs, quants, geometry, mesh, device="cpu")
