"""PyTorch port, every wire of ``to_rgb8_device`` on the CPU: the v1
plane-order wire (progressive, arithmetic and staged results after
``prepack``), the v1 MCU wire (``JPX_WIRE=1``), the dense planes
(``sparse=False``) and the v2 wire, at full size and at 1/2, 1/4 and
1/8, held against the JAX package's ``to_rgb8_device`` on the same
result and against its host writers (``to_rgb8``, ``to_rgb8_scaled``).

Tolerances: full size, the JAX package's device contract (at most 2 RGB
levels on at most 1e-4 of the values); scaled, the JAX package's own
scaled contract between its device and host paths (at most 2 levels on
under 5% of the values): the reduced IDCT's sums sit near .5 ties more
often (about one sample in eight at 1/4), where any two sum orders round
apart. The wires carry the same coefficients, so they must give equal
images."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jpeglibrary_tpu as jt
import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu.models.progressive_encoder import encode_progressive_rgb

from torch_reference_native import settle

settle()  # the JAX package's native scanner, built once before any test

SCALES = [1.0, 0.5, 0.25, 0.125]


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, w)[None, :, None] + np.linspace(0, 90, h)[:, None, None]
    return np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


def _decode(data, wire, decode=jtt.decode):
    """``data`` on ``wire`` through the port's host decode, or through
    ``decode``'s (the JAX package's, for its own device path)."""
    if wire == "v1":
        os.environ["JPX_WIRE"] = "1"
        try:
            res = decode(data, sparse_direct=True)
        finally:
            del os.environ["JPX_WIRE"]
        assert res.packed_mcu is not None and res.packed_mcu2 is None
        return res
    if wire == "staged":
        return decode(data)  # dense planes, no fused-scan payload
    res = decode(data, sparse_direct=True)
    res.prepack()
    if wire == "delta":
        assert res.packed_mcu is None and res.packed_mcu2 is None
        assert getattr(res, "_packed", None) is not None
    else:
        assert res.packed_mcu2 is not None
    return res


CASES = {
    "progressive": (lambda: encode_progressive_rgb(_image(80, 112, 1), 85), "delta"),
    "arithmetic": (lambda: jt.encode_rgb(_image(80, 112, 2), 85, arithmetic=True), "delta"),
    "arithmetic_gray": (
        lambda: jt.encode_gray(_image(53, 41, 3)[..., 0], 80, arithmetic=True), "delta"),
    "v1_420": (lambda: jt.encode_rgb(_image(80, 112, 4), 80), "v1"),
    "v1_odd_444": (lambda: jt.encode_rgb(_image(45, 70, 5), 90, subsampling="444"), "v1"),
    "staged_sparse": (lambda: jt.encode_rgb(_image(80, 112, 6), 75), "staged"),
    "v2_422": (lambda: jt.encode_rgb(_image(80, 112, 7), 75, subsampling="422"), "v2"),
}


def _contract(got, want, share=1e-4):
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 2 and (d > 0).sum() <= d.size * share, (d.max(), (d > 0).sum())


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make, wire = CASES[request.param]
    data = make()
    return _decode(data, wire), _decode(data, wire, jt.decode)


@pytest.mark.parametrize("scale", SCALES)
def test_wire_matches_jax_device_and_host(case, scale):
    res, ref = case
    got = jtt.to_rgb8_device(res, device="cpu", scale=scale)
    n = int(8 * scale)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert tuple(got.shape) == (3, -(-res.height * n // 8), -(-res.width * n // 8))
    share = 1e-4 if scale == 1 else 0.05
    _contract(got.numpy(), np.asarray(ref.to_rgb8_device(scale=scale)), share)
    host = ref.to_rgb8() if scale == 1 else ref.to_rgb8_scaled(scale)
    _contract(got.numpy(), np.moveaxis(host, -1, 0), share)


def test_dense_entry_matches_jax_dense():
    """``sparse=False`` on a result without a payload takes the dense
    planes (the JAX ``jitted_transform(..., "rgb8p")``)."""
    data = jt.encode_rgb(_image(72, 88, 8), 80, subsampling="420")
    res = jtt.decode(data)
    got = jtt.to_rgb8_device(res, device="cpu", sparse=False)
    _contract(got.numpy(), np.asarray(jt.decode(data).to_rgb8_device(sparse=False)))
    assert torch.equal(got, jtt.to_rgb8_device(res, device="cpu", sparse=True))
    with pytest.raises(ValueError, match="sparse"):
        jtt.to_rgb8_device(res, device="cpu", sparse=False, scale=0.5)


@pytest.mark.parametrize("scale", SCALES)
def test_v1_and_v2_wires_agree(scale):
    """The same stream through the v2 wire, the v1 MCU wire, the v1
    plane-order wire and the dense planes gives one image."""
    data = jt.encode_rgb(_image(80, 112, 9), 80, restart_interval=5)
    outs = [jtt.to_rgb8_device(_decode(data, wire), device="cpu", scale=scale)
            for wire in ("v2", "v1", "staged")]
    if scale == 1:
        outs.append(jtt.to_rgb8_device(jtt.decode(data), device="cpu", sparse=False))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_grouped_stream_v1_equals_v2():
    rgb = _image(64, 96, 10)
    datas = [jt.encode_rgb(rgb, 80), jt.encode_rgb(rgb[::-1].copy(), 80),
             jt.encode_rgb(rgb[:, ::-1].copy(), 80)]
    v2 = list(jtt.decode_stream_rgb(datas, device="cpu", group=3))
    os.environ["JPX_WIRE"] = "1"
    try:
        v1 = list(jtt.decode_stream_rgb(datas, device="cpu", group=3))
    finally:
        del os.environ["JPX_WIRE"]
    for a, b in zip(v1, v2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("offset", [0, 3])
def test_delta_densify_spare_slot(offset):
    """An image with no coefficient at all packs to bucket padding only,
    whose positions sit at -1 (JAX wraps that scatter to the last slot and
    adds 0; ``index_add_`` would raise): beside a normal image in one
    stacked call it decodes to flat mid-gray."""
    from jpeglibrary_tpu_torch.host.native import scanner as ns
    from jpeglibrary_tpu_torch.ops import pipeline

    flat = jtt.decode(jt.encode_gray(np.full((16, 24), 128, np.uint8), 90))
    other = jtt.decode(jt.encode_gray(_image(16, 24, 11)[..., 0], 90))
    geo = flat.geometry
    assert not flat.coefficients[geo.components[0].component_index].any()
    packs = [ns.pack_sparse([r.coefficients[geo.components[0].component_index]]).reshape(-1)
             for r in (flat, other)]
    width = max(p.shape[0] for p in packs) + 2 * offset
    stacked = np.zeros((2, width), dtype=np.int16)
    for j, p in enumerate(packs):
        stacked[j, : p.shape[0]] = p
    (planes,) = pipeline.densify_delta(torch.from_numpy(stacked), geo)
    assert not planes[0].any()
    np.testing.assert_array_equal(planes[1].numpy(),
                                  other.coefficients[geo.components[0].component_index])
