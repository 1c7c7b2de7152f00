"""PyTorch port, integer ops and the v2 densify: bit-exact against the
JAX package's numpy functions on the same arrays."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jpeglibrary_tpu as jt
import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu.models import decoder as ref_decoder
from jpeglibrary_tpu.models import geometry as ref_geometry
from jpeglibrary_tpu.native import scanner as ns
from jpeglibrary_tpu.ops import color as ref_color
from jpeglibrary_tpu.ops import decode_stage as ref_stage
from jpeglibrary_tpu_torch.host.models import geometry as host_geometry
from jpeglibrary_tpu_torch.ops import color, decode_stage, pipeline


def _gradient_noise(h, w, seed, sigma=30.0):
    rng = np.random.default_rng(seed)
    return np.clip(
        np.linspace(0, 255, w)[None, :, None] + rng.normal(0, sigma, (h, w, 3)), 0, 255
    ).astype(np.uint8)


def test_ycbcr_to_rgb_bit_exact():
    rng = np.random.default_rng(0)
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    cb = cb.reshape(-1).astype(np.uint8)
    cr = cr.reshape(-1).astype(np.uint8)
    y = rng.integers(0, 256, cb.shape, dtype=np.uint8)
    want = ref_color.ycbcr_to_rgb(y, cb, cr)
    got = color.ycbcr_to_rgb(torch.from_numpy(y), torch.from_numpy(cb), torch.from_numpy(cr))
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), w)


def test_blocks_to_plane_bit_exact():
    rng = np.random.default_rng(1)
    s = rng.integers(-300, 300, (5, 7, 8, 8), dtype=np.int32)
    got = decode_stage.blocks_to_plane(torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), ref_stage.blocks_to_plane(s))


@pytest.mark.parametrize("hs,vs", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_upsample_duplicate_bit_exact(hs, vs):
    rng = np.random.default_rng(2)
    p = rng.integers(-50, 300, (13, 9), dtype=np.int32)
    got = decode_stage.upsample_duplicate(torch.from_numpy(p), hs, vs)
    np.testing.assert_array_equal(got.numpy(), ref_stage.upsample_duplicate(p, hs, vs))


@pytest.mark.parametrize("precision", [8, 12, 4, 3, 5])
def test_normalize_to_uint8_bit_exact(precision):
    rng = np.random.default_rng(precision)
    top = 1 << precision
    p = rng.integers(-top, 2 * top, (31, 17), dtype=np.int32)
    got = decode_stage.normalize_to_uint8(torch.from_numpy(p), precision)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref_stage.normalize_to_uint8(p, precision))


def test_clamp_to_uint8_bit_exact():
    p = np.arange(-300, 600, dtype=np.int32).reshape(30, 30)
    got = decode_stage.clamp_to_uint8(torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), ref_stage.clamp_to_uint8(p))


def _assert_densify_matches(result, ref):
    """The port's densify of the port's ``result`` against the JAX
    package's numpy densify of ``ref``, the same stream's reference result."""
    np.testing.assert_array_equal(result.packed_mcu2, ref.packed_mcu2)
    got = pipeline.densify_mcu2(torch.from_numpy(result.packed_mcu2)[None], result.geometry)
    want = ref._densify_packed2()
    for plane, cg in zip(got, result.geometry.components):
        assert plane.dtype == torch.int32
        np.testing.assert_array_equal(plane[0].numpy(), want[cg.component_index])


def _nb(geometry):
    bpm = sum(c.h * c.v for c in geometry.components)
    return geometry.mcus_per_line * geometry.mcus_per_column * bpm


def _both(data):
    """The stream's result from the port's host decode and the JAX package's."""
    return jtt.decode(data, sparse_direct=True), jt.decode(data, sparse_direct=True)


@pytest.mark.parametrize("sub", ["444", "422", "420"])
def test_densify_bit_exact(sub):
    res, ref = _both(jt.encode_rgb(_gradient_noise(96, 120, 3), 80, subsampling=sub))
    assert res.packed_mcu2 is not None
    _assert_densify_matches(res, ref)


def test_densify_exceptions_and_odd_block_count():
    """q95 4:4:4 has |AC| > 127 exceptions, and 211x333 gives NB = 3402,
    so the exception block starts at an offset not divisible by 4."""
    res, ref = _both(jt.encode_rgb(_gradient_noise(211, 333, 4), 95, subsampling="444"))
    payload, nb = res.packed_mcu2, _nb(res.geometry)
    assert nb % 4 != 0
    bn = ns.v2_payload_bn(payload, nb)
    exc = payload[3 * nb + 2 * bn :].view(np.int32).reshape(-1, 2)
    assert np.any(exc[:, 1] != 0)
    _assert_densify_matches(res, ref)


def test_densify_rebucketed_with_flat_tail():
    """A larger AC bucket (zero padding) and trailing blocks with no AC
    entries: their markers and the padding entries must add nothing."""
    rgb = _gradient_noise(80, 96, 5)
    rgb[48:] = 128
    res, ref = _both(jt.encode_rgb(rgb, 75, subsampling="420"))
    nb = _nb(res.geometry)
    bn = ns.v2_payload_bn(res.packed_mcu2, nb)
    for r in (res, ref):
        r.packed_mcu2 = ns.rebucket_v2_payload(r.packed_mcu2, nb, bn + 2048)
    assert res.packed_mcu2[2 * nb : 3 * nb][-6:].max() == 0
    _assert_densify_matches(res, ref)


def test_densify_full_bucket_out_of_bounds_markers():
    """AC bucket exactly full: the trailing zero-count blocks start at
    slot Bn, past the end of the bucket (JAX drops that scatter)."""
    rng = np.random.default_rng(6)
    geos = [g.FrameGeometry(64, 32, 8, 1, 1, 8, 4, (g.ComponentGeometry(0, 1, 1, 1, 1, 1, 8, 4),))
            for g in (host_geometry, ref_geometry)]
    nb, bn = 32, 1024
    counts = np.zeros(nb, dtype=np.uint8)
    counts[:20] = 51
    counts[20] = 4  # sum == bn; blocks 21..31 have no entries
    acpos = np.concatenate(
        [np.sort(rng.choice(np.arange(1, 64), int(c), replace=False)) for c in counts]
    ).astype(np.uint8)
    acval = rng.choice(np.r_[-127:0, 1:128], bn).astype(np.int8)
    dc = rng.integers(-1000, 1000, nb).astype(np.int16)
    exc = np.zeros((bn // 64, 2), dtype=np.int32)
    exc[:3] = [[5 * 64 + int(acpos[5 * 51]), 400], [64 * 31 + 7, -900], [64 * 2 + 63, 1]]
    payload = np.concatenate(
        [dc.view(np.uint8), counts, acpos, acval.view(np.uint8), exc.reshape(-1).view(np.uint8)]
    )
    assert ns.v2_payload_bn(payload, nb) == bn
    res = jtt.DecodeResult(frame=None, geometry=geos[0], packed_mcu2=payload)
    ref = ref_decoder.DecodeResult(frame=None, geometry=geos[1], packed_mcu2=payload)
    _assert_densify_matches(res, ref)
