"""PyTorch port, the last two branches of the device transform on the CPU:
libjpeg's fancy upsampling and the 16-bit extending writer (``output="u16"``),
held against the JAX package's device transforms run on the CPU backend
(``jitted_transform_mcu2`` / ``_mcu`` / ``_delta`` and ``jitted_transform``)
over streams the JAX host encoder writes.

Tolerance: RGB within 2 levels on at most 1e-4 of the values; u16 samples
(``>> (16 - precision)``) within 1 on at most 1e-4. The integer ops
(``upsample_fancy``, ``extend_to_uint16``) are bit-exact against numpy."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jpeglibrary_tpu as jt
import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu.models.progressive_encoder import encode_progressive_rgb
from jpeglibrary_tpu.ops import decode_stage as ref_stage
from jpeglibrary_tpu.ops import pipeline as ref_pipeline
from jpeglibrary_tpu_torch.models.decoder import delta_payload, quant_tables
from jpeglibrary_tpu_torch.ops import decode_stage

from torch_reference_native import settle

settle()  # the JAX package's native scanner, built once before any test


def _image(h, w, seed, sigma=20.0):
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, w)[None, :, None] + np.linspace(0, 80, h)[:, None, None]
    return np.clip(base + rng.normal(0, sigma, (h, w, 3)), 0, 255).astype(np.uint8)


def _gray12(h, w, seed):
    """12-bit samples near the level shift (2048). The fp32 product's
    rounding error grows with the size of a sample's distance from it, and
    with it the share of samples that sit within that error of a .5 tie
    and round one way here and the other in the JAX package (the 1-LSB
    contract): at full 12-bit range about 1e-4, the bound itself."""
    rng = np.random.default_rng(seed)
    return np.clip(np.linspace(1700, 2400, w)[None, :] + rng.normal(0, 40, (h, w)),
                   0, 4095).astype(np.uint16)


# --- the integer ops, bit-exact against numpy -------------------------------

@pytest.mark.parametrize("hs,vs", [(2, 1), (2, 2), (1, 2), (3, 1), (1, 1), (4, 2), (1, 3)])
@pytest.mark.parametrize("shape", [(17, 23), (1, 1), (2, 9)])
def test_upsample_fancy_bit_exact(hs, vs, shape):
    planes = np.random.default_rng(hs * 10 + vs + shape[0]).integers(
        0, 256, (3,) + shape).astype(np.uint8)
    got = decode_stage.upsample_fancy(torch.from_numpy(planes), hs, vs)
    want = np.stack([ref_stage.upsample_fancy(p, hs, vs) for p in planes])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("precision", [2, 5, 7, 8, 12, 16])
def test_extend_to_uint16_bit_exact(precision):
    plane = np.random.default_rng(precision).integers(-70000, 70000, (33, 45)).astype(np.int32)
    got = decode_stage.extend_to_uint16(torch.from_numpy(plane), precision)
    want = ref_stage.extend_to_uint16(plane, precision)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)


# --- through the device transforms -----------------------------------------

def _cmyk():
    ink = np.concatenate([_image(48, 64, 5), _image(48, 64, 6)[..., :1]], -1)
    return jt.encode_cmyk(ink, 80, ycck=True)


# name: (stream maker, JPX_WIRE value or None)
STREAMS = {
    "420": (lambda: jt.encode_rgb(_image(64, 96, 1), 75, subsampling="420"), None),
    "422": (lambda: jt.encode_rgb(_image(64, 96, 2), 75, subsampling="422"), None),
    "444": (lambda: jt.encode_rgb(_image(64, 96, 3), 75, subsampling="444"), None),
    "gray": (lambda: jt.encode_gray(_image(64, 96, 4)[..., 0], 80), None),
    "ragged_211x333": (lambda: jt.encode_rgb(_image(211, 333, 7), 75), None),
    "v1_wire_420": (lambda: jt.encode_rgb(_image(64, 96, 8), 80), "1"),
    "progressive_420": (lambda: encode_progressive_rgb(_image(64, 96, 9), 85), None),
    "gray12": (lambda: jt.encode_gray(_gray12(160, 240, 10), 85, precision=12), None),
    "ycck_420": (_cmyk, None),
}


def _decode(decode, data, wire):
    saved = os.environ.get("JPX_WIRE")
    if wire is not None:
        os.environ["JPX_WIRE"] = wire
    try:
        return decode(data, sparse_direct=True)
    finally:
        if saved is None:
            os.environ.pop("JPX_WIRE", None)
        else:
            os.environ["JPX_WIRE"] = saved


@pytest.fixture(scope="module", params=sorted(STREAMS))
def stream(request):
    make, wire = STREAMS[request.param]
    data = make()
    ours = _decode(jtt.decode, data, wire)
    ref = _decode(jt.decode, data, wire)
    return request.param, ours, ref


def _wire_pair(ours, ref, output, upsample):
    """The port's wire transform and the JAX one, on each package's own
    result, for the wire the result carries (the order to_rgb8_device
    takes them in)."""
    quants = quant_tables(ours)
    if ours.packed_mcu2 is not None:
        got = jtt.transform_mcu2(ours.packed_mcu2, quants, ours.geometry, "cpu",
                                 upsample=upsample, output=output)
        want = ref_pipeline.jitted_transform_mcu2(ref.geometry, output, upsample)(
            ref.packed_mcu2, quants)
    elif ours.packed_mcu is not None:
        got = jtt.transform_mcu(ours.packed_mcu, quants, ours.geometry, "cpu",
                                upsample=upsample, output=output)
        want = ref_pipeline.jitted_transform_mcu(ref.geometry, output, upsample)(
            ref.packed_mcu, quants)
    else:
        packed = delta_payload(ours)
        got = jtt.transform_delta(packed, quants, ours.geometry, "cpu",
                                  upsample=upsample, output=output)
        want = ref_pipeline.jitted_transform_delta(ref.geometry, output, upsample)(
            packed, quants)
    return got, np.asarray(want)


def _assert_rgb_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int64) - want)
    assert d.max() <= 2 and (d > 0).mean() <= 1e-4, (d.max(), (d > 0).mean())


def _assert_u16_close(got, want, precision):
    """Compared as samples, ``>> (16 - precision)``. The writer takes a
    sample as a ushort, so one 1 below 0 (the other package's 0) comes out
    at the top: such a pair counts as the 1-LSB difference it is."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint16
    shift = 16 - precision
    a, b = got.astype(np.int64) >> shift, want.astype(np.int64) >> shift
    top = (1 << precision) - 1
    wrapped = ((a == top) & (b == 0)) | ((a == 0) & (b == top))
    d = np.where(wrapped, 1, np.abs(a - b))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (d.max(), (d > 0).mean())


def test_wire_transform_fancy_matches_jax(stream):
    name, ours, ref = stream
    if name == "ycck_420":  # 4 components: no RGB output, in either package
        with pytest.raises(ValueError):
            _wire_pair(ours, ref, "rgb8", "fancy")
        with pytest.raises(ValueError):
            ref_pipeline.jitted_transform_mcu2(ref.geometry, "rgb8", "fancy")(
                ref.packed_mcu2, quant_tables(ours))
        return
    got, want = _wire_pair(ours, ref, "rgb8", "fancy")
    assert got.shape == (3, ours.height, ours.width)
    _assert_rgb_close(got.numpy(), want)


def test_wire_transform_u16_matches_jax(stream):
    name, ours, ref = stream
    got, want = _wire_pair(ours, ref, "u16", "duplicate")
    n_comp = len(ours.geometry.components)
    assert tuple(got.shape) == (ours.height, ours.width, n_comp)
    _assert_u16_close(got.numpy(), want, ours.geometry.precision)
    # The 16-bit writer is the host golden path's format.
    _assert_u16_close(got.numpy(), ref.to_uint16_extended()[..., :n_comp],
                      ours.geometry.precision)


@pytest.mark.parametrize("output", ["rgb8", "rgb8p", "u16"])
def test_dense_transform_outputs_match_jax(stream, output):
    name, ours, ref = stream
    comps = ours.geometry.components
    planes = [ours.coefficients[c.component_index] for c in comps]
    quants = quant_tables(ours)
    ref_planes = tuple(ref.coefficients[c.component_index] for c in ref.geometry.components)
    if name == "ycck_420" and output != "u16":  # 4 components: no RGB output
        with pytest.raises(ValueError):
            jtt.transform_dense(planes, quants, ours.geometry, "cpu", output=output)
        with pytest.raises(ValueError):
            ref_pipeline.jitted_transform(ref.geometry, output, "fancy")(ref_planes,
                                                                         tuple(quants))
        return
    got = jtt.transform_dense(planes, quants, ours.geometry, "cpu", output=output,
                              upsample="fancy").numpy()
    want = np.asarray(ref_pipeline.jitted_transform(ref.geometry, output, "fancy")(
        ref_planes, tuple(quants)))
    if output == "u16":
        _assert_u16_close(got, want, ours.geometry.precision)
    else:
        _assert_rgb_close(got, want)


def test_to_rgb8_device_fancy_matches_jax(stream):
    name, ours, ref = stream
    if name == "ycck_420":
        with pytest.raises(ValueError):
            jtt.to_rgb8_device(ours, device="cpu", upsample="fancy")
        return
    got = jtt.to_rgb8_device(ours, device="cpu", upsample="fancy")
    _assert_rgb_close(got.numpy(), np.asarray(ref.to_rgb8_device(upsample="fancy")))
    dense = jtt.to_rgb8_device(ours, device="cpu", upsample="fancy", sparse=False)
    _assert_rgb_close(dense.numpy(), np.asarray(ref.to_rgb8_device(upsample="fancy",
                                                                   sparse=False)))


@pytest.mark.parametrize("scale", [0.5, 0.25, 0.125])
def test_fancy_below_full_size_raises(scale):
    data = STREAMS["420"][0]()
    res = jtt.decode(data, sparse_direct=True)
    with pytest.raises(ValueError):
        jtt.to_rgb8_device(res, device="cpu", upsample="fancy", scale=scale)
    with pytest.raises(ValueError):  # as the JAX transform does
        ref_pipeline.jitted_transform_mcu2(res.geometry, "rgb8", "fancy", int(8 * scale))(
            res.packed_mcu2, quant_tables(res))
    with pytest.raises(ValueError):
        jtt.transform_mcu2(res.packed_mcu2, quant_tables(res), res.geometry, "cpu",
                           output="u16", scale_n=int(8 * scale))


def test_unknown_upsample_or_output_raises():
    res = jtt.decode(STREAMS["444"][0](), sparse_direct=True)
    q = quant_tables(res)
    with pytest.raises(ValueError):
        jtt.transform_mcu2(res.packed_mcu2, q, res.geometry, "cpu", upsample="bicubic")
    with pytest.raises(ValueError):
        jtt.transform_mcu2(res.packed_mcu2, q, res.geometry, "cpu", output="rgb16")
    planes = [res.coefficients[c.component_index] for c in res.geometry.components]
    with pytest.raises(ValueError):
        jtt.transform_dense(planes, q, res.geometry, "cpu", output="hwc")


def test_stacked_fancy_and_u16_equal_single_images():
    """A stacked batch of two images gives each image's own output."""
    datas = [jt.encode_rgb(_image(64, 96, s), 75) for s in (20, 21)]
    ress = [jtt.decode(d, sparse_direct=True) for d in datas]
    geometry = ress[0].geometry
    from jpeglibrary_tpu_torch.parallel.batch import group_wire

    transform, stacked, quants = group_wire(ress, geometry)
    for kw in ({"upsample": "fancy"}, {"output": "u16"}):
        both = transform(stacked, quants, geometry, "cpu", **kw)
        for i, r in enumerate(ress):
            one = jtt.transform_mcu2(r.packed_mcu2, quant_tables(r), geometry, "cpu", **kw)
            assert torch.equal(both[i], one)
