"""PyTorch port, the batch step (parallel/sharding.py) and its parts on the
CPU, against the JAX package: ``full_step`` against the JAX ``full_step``
on inputs shaped as ``__graft_entry__._example_args`` (rebuilt here), its
histograms against the host gather of its own requantised blocks,
``symbol_histograms_device`` with and without ``n_valid`` masking,
``rgb_to_ycbcr``, ``batched_transform_rgb`` and ``assemble_stripes``.

Tolerances: the step's RGB within 1 level and its requantised luma and
chroma within 1 on at most 1e-4 of the values (the chroma against the
JAX step's own box and FDCT of the JAX step's RGB). The port's K1 is a folded-matrix
product where the JAX step runs the butterfly IDCT, and its K2 sums the
FDCT in another order than XLA's dot, so a value within an ulp of a .5
tie may round the other way (at these shapes none does: 0 values
differ). The histograms and the colour conversion are integer arithmetic
and exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from jpeglibrary_tpu.ops import color as ref_color
from jpeglibrary_tpu.ops import encode_stage as ref_encode_stage
from jpeglibrary_tpu.parallel import sharding as ref_sharding
from jpeglibrary_tpu.syntax.quantization import (
    STANDARD_CHROMINANCE_ZIGZAG,
    STANDARD_LUMINANCE_ZIGZAG,
)

import jpeglibrary_tpu_torch.parallel as port_parallel
from jpeglibrary_tpu_torch.host.ops import encode_stage as host_encode_stage
from jpeglibrary_tpu_torch.ops import color, encode_stage, kernels
from jpeglibrary_tpu_torch.parallel import sharding

from torch_reference_native import settle

settle()  # the JAX package's native scanner, built once before any test


def _example_args(batch=2, hb=8, wb=16, seed=0):
    """``__graft_entry__._example_args``: random zig-zag coefficients and
    the standard tables."""
    rng = np.random.default_rng(seed)
    y = rng.integers(-64, 64, size=(batch, hb, wb, 64), dtype=np.int16)
    cb = rng.integers(-32, 32, size=(batch, hb // 2, wb // 2, 64), dtype=np.int16)
    cr = rng.integers(-32, 32, size=(batch, hb // 2, wb // 2, 64), dtype=np.int16)
    return (y, cb, cr, STANDARD_LUMINANCE_ZIGZAG.astype(np.int32),
            STANDARD_CHROMINANCE_ZIGZAG.astype(np.int32))


SHAPES = [(2, 8, 16, 0), (3, 16, 16, 1)]  # (batch, hb, wb, seed); the first is _example_args


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s[:3])))
def steps(request):
    b, hb, wb, seed = request.param
    args = _example_args(b, hb, wb, seed)
    want = [np.asarray(x) for x in jax.jit(ref_sharding.full_step)(*args)]
    before = (kernels.dequantize_idct_shift.launches, kernels.fdct_quantize.launches)
    got = sharding.full_step(*args, device="cpu")
    after = (kernels.dequantize_idct_shift.launches, kernels.fdct_quantize.launches)
    assert after == before  # CPU tensors take the plain versions
    return args, got, want


@pytest.fixture(scope="module")
def requants(steps):
    """The step's three requantised components (full_step returns the
    luma alone), from the same step through ``_step``."""
    args, (rgb, requant, hists), _ = steps
    rgb_, requants, hists_ = sharding._step(*sharding._step_inputs(*args, "cpu"),
                                            kernels.dequantize_idct_shift, kernels.fdct_quantize)
    assert torch.equal(rgb_, rgb) and torch.equal(requants[0], requant)
    assert torch.equal(hists_, hists)
    return requants


def _jax_chroma(rgb, qt_chroma):
    """The JAX step's requantised Cb and Cr of its own RGB: its colour
    conversion, ``box2x2`` and ``_fdct_quantize_batch`` (sharding.py:117-127)."""
    _, cb, cr = ref_color.rgb_to_ycbcr(rgb[..., 0], rgb[..., 1], rgb[..., 2], xp=jnp)

    def box2x2(p):
        x = p.astype(jnp.int32).reshape(p.shape[0], p.shape[1] // 2, 2, p.shape[2] // 2, 2)
        return (jnp.sum(x, axis=(2, 4)) + 2) >> 2

    return [np.asarray(ref_sharding._fdct_quantize_batch(box2x2(p), qt_chroma, jnp))
            for p in (cb, cr)]


def test_full_step_shapes(steps):
    (y, *_), (rgb, requant, hists), _ = steps
    b, hb, wb, _ = y.shape
    assert rgb.dtype == torch.uint8 and tuple(rgb.shape) == (b, hb * 8, wb * 8, 3)
    assert requant.dtype == torch.int16 and tuple(requant.shape) == y.shape
    assert hists.dtype == torch.int32 and tuple(hists.shape) == (4, 256)
    assert int(hists[0].sum()) == b * hb * wb  # one DC symbol per block
    assert int(hists[2].sum()) == 2 * b * (hb // 2) * (wb // 2)


def test_full_step_rgb_matches_jax(steps):
    _, (rgb, _, _), (want, _, _) = steps
    d = np.abs(rgb.numpy().astype(np.int64) - want)
    assert d.max() <= 1 and (d > 0).sum() <= d.size * 1e-4, (d.max(), (d > 0).sum())


def test_full_step_requant_matches_jax(steps):
    _, (_, requant, _), (_, want, _) = steps
    d = np.abs(requant.numpy().astype(np.int64) - want)
    assert d.max() <= 1 and (d > 0).sum() <= d.size * 1e-4, (d.max(), (d > 0).sum())


def test_full_step_chroma_requant_matches_jax(steps, requants):
    (*_, qt_c), _, (want_rgb, _, _) = steps
    for got, want in zip(requants[1:], _jax_chroma(jnp.asarray(want_rgb), qt_c)):
        assert got.dtype == torch.int16 and tuple(got.shape) == want.shape
        d = np.abs(got.numpy().astype(np.int64) - want)
        assert d.max() <= 1 and (d > 0).sum() <= d.size * 1e-4, (d.max(), (d > 0).sum())


def test_full_step_histograms_are_host_gather(steps, requants):
    """The four histograms equal the host copy's gather applied to the
    step's own requantised blocks, luma and chroma."""
    _, (_, _, hists), _ = steps
    dc = np.zeros((2, 256), np.int64)
    ac = np.zeros((2, 256), np.int64)
    for img in requants[0].numpy():
        d, a = host_encode_stage.dc_ac_symbol_frequencies(host_encode_stage.mcu_order_blocks(img, 2, 2))
        dc[0] += d
        ac[0] += a
    for plane in requants[1:]:
        for img in plane.numpy():
            d, a = host_encode_stage.dc_ac_symbol_frequencies(img.reshape(-1, 64))
            dc[1] += d
            ac[1] += a
    np.testing.assert_array_equal(hists.numpy(), np.stack([dc[0], ac[0], dc[1], ac[1]]))


def test_full_step_histograms_match_jax(steps):
    """At these shapes no requantised value differs from the JAX step's,
    so the histograms are equal."""
    _, (_, _, hists), (_, _, want) = steps
    np.testing.assert_array_equal(hists.numpy(), want)


@pytest.mark.parametrize("shape,lo,hi", [((1, 97, 64), -300, 300), ((3, 40, 64), -2047, 2048),
                                         ((2, 16, 64), -3, 3)])
def test_symbol_histograms_match_jax(shape, lo, hi):
    rng = np.random.default_rng(shape[1])
    blocks = rng.integers(lo, hi, size=shape).astype(np.int32)
    blocks[..., 20:] *= rng.random(shape[:2] + (44,)) < 0.2  # zero runs, ZRLs and EOBs
    dc, ac = encode_stage.symbol_histograms_device(torch.from_numpy(blocks))
    want_dc, want_ac = jax.jit(lambda b: ref_encode_stage.symbol_histograms_device(b, jnp))(blocks)
    assert dc.dtype == ac.dtype == torch.int32
    np.testing.assert_array_equal(dc.numpy(), np.asarray(want_dc))
    np.testing.assert_array_equal(ac.numpy(), np.asarray(want_ac))
    for row in blocks:
        host_dc, host_ac = host_encode_stage.dc_ac_symbol_frequencies(row)
        if shape[0] == 1:
            np.testing.assert_array_equal(dc.numpy(), host_dc)
            np.testing.assert_array_equal(ac.numpy(), host_ac)


def test_symbol_histograms_masking():
    """Padding past n_valid counts nothing (tests/test_mesh_statistics.py:38-49)."""
    rng = np.random.default_rng(3)
    blocks = rng.integers(-300, 300, size=(97, 64), dtype=np.int32)
    want_dc, want_ac = host_encode_stage.dc_ac_symbol_frequencies(blocks)
    padded = np.zeros((1, 104, 64), dtype=np.int32)
    padded[0, :97] = blocks
    dc, ac = encode_stage.symbol_histograms_device(torch.from_numpy(padded),
                                                   n_valid=torch.tensor([97]))
    np.testing.assert_array_equal(dc.numpy(), want_dc)
    np.testing.assert_array_equal(ac.numpy(), want_ac)
    ref_dc, ref_ac = jax.jit(
        lambda b, nv: ref_encode_stage.symbol_histograms_device(b, jnp, n_valid=nv)
    )(padded, jnp.asarray([97]))
    np.testing.assert_array_equal(dc.numpy(), np.asarray(ref_dc))
    np.testing.assert_array_equal(ac.numpy(), np.asarray(ref_ac))


def test_rgb_to_ycbcr_matches_jax():
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, size=(3, 64, 257), dtype=np.uint8)
    rgb[:, 0, :8] = [[0], [255], [0]]  # the extremes
    got = color.rgb_to_ycbcr(*(torch.from_numpy(c) for c in rgb))
    want = ref_color.rgb_to_ycbcr(*rgb)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), w)


def test_batched_transform_rgb_matches_jax():
    from jpeglibrary_tpu.models.geometry import frame_geometry as ref_frame_geometry
    from jpeglibrary_tpu.syntax.frame import FrameComponent, FrameHeader

    from jpeglibrary_tpu_torch.host.models.geometry import frame_geometry

    y, cb, cr, ql, qc = _example_args(3, 4, 6, seed=5)
    frame = FrameHeader(0xC0, 8, 32, 48, (FrameComponent(1, 2, 2, 0), FrameComponent(2, 1, 1, 1),
                                          FrameComponent(3, 1, 1, 1)))
    geo = frame_geometry(frame)
    batch = [(y[i], cb[i], cr[i]) for i in range(3)]
    got = port_parallel.batched_transform_rgb(batch, (ql, qc, qc), geo, device="cpu")
    want = np.asarray(ref_sharding.batched_transform_rgb(batch, (ql, qc, qc),
                                                         ref_frame_geometry(frame)))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (3, 32, 48, 3)
    d = np.abs(got.numpy().astype(np.int64) - want)
    assert d.max() <= 1 and (d > 0).sum() <= d.size * 1e-4, (d.max(), (d > 0).sum())


def test_mesh_raises():
    """A mesh that is no DeviceMesh of ``make_mesh``'s kind raises (the
    mesh itself is held in tests/test_torch_mesh.py)."""
    y, cb, cr, ql, qc = _example_args()
    with pytest.raises(ValueError, match="mesh"):
        port_parallel.batched_transform_rgb([(y[0], cb[0], cr[0])], (ql, qc, qc), None,
                                            mesh=object(), device="cpu")


def test_assemble_stripes_matches_jax():
    rng = np.random.default_rng(2)
    stripes = rng.integers(0, 256, size=(4, 3, 16, 24), dtype=np.uint8)
    heights = [16, 16, 5, 0]
    want = ref_sharding.assemble_stripes(stripes, heights)
    np.testing.assert_array_equal(sharding.assemble_stripes(stripes, heights), want)
    np.testing.assert_array_equal(sharding.assemble_stripes(torch.from_numpy(stripes), heights),
                                  want)
    assert want.shape == (3, 37, 24)


def test_parallel_exports():
    assert port_parallel.full_step is sharding.full_step
    assert port_parallel.batched_transform_rgb is sharding.batched_transform_rgb
    assert set(port_parallel.__all__) >= {"full_step", "batched_transform_rgb",
                                          "decode_batch_rgb", "decode_stream_rgb"}
