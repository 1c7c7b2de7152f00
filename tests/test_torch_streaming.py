"""PyTorch port, the bounded-memory stripe decode on the CPU
(``jpeglibrary_tpu_torch.models.streaming`` over the host copy of the
stripe split): the stitched stripes equal the port's full decode exactly,
the stripe split and the lossless row stream equal the JAX package's, and
the cases of the JAX package's tests/test_streaming.py hold, on streams
the JAX host encoder writes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jpeglibrary_tpu as jt
import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu.models import streaming as ref_streaming
from jpeglibrary_tpu.models.lossless import encode_lossless
from jpeglibrary_tpu.models.progressive_encoder import encode_progressive_rgb
from jpeglibrary_tpu_torch.host.models import streaming as host_streaming
from jpeglibrary_tpu_torch.models import streaming
from jpeglibrary_tpu_torch.ops import kernels


def _image(h, w, seed, sigma=20.0):
    rng = np.random.default_rng(seed)
    return np.clip(np.linspace(0, 255, w)[None, :, None] + rng.normal(0, sigma, (h, w, 3)),
                   0, 255).astype(np.uint8)


def _full(data):
    return jtt.to_rgb8_device(jtt.decode(data, sparse_direct=True), device="cpu")


def _stitch(data, rows, **kw):
    out, next_y = [], 0
    for y0, stripe in jtt.decode_rgb_stripes(data, device="cpu", stripe_mcu_rows=rows, **kw):
        assert y0 == next_y
        out.append(stripe)
        next_y += stripe.shape[1]
    return out


@pytest.mark.parametrize("sub,h,w,rows", [
    ("420", 200, 152, 8),
    ("420", 200, 152, 7),   # an uneven final stripe
    ("444", 203, 96, 16),   # an odd height
    ("gray", 121, 88, 3),
])
def test_stripes_equal_full_decode(sub, h, w, rows):
    img = _image(h, w, seed=h + rows)
    data = (jt.encode_gray(img[..., 0], 80) if sub == "gray"
            else jt.encode_rgb(img, 80, subsampling=sub))
    stripes = _stitch(data, rows)
    assert all(s.dtype == torch.uint8 and s.device.type == "cpu" for s in stripes)
    full = _full(data)
    assert torch.equal(torch.cat(stripes, dim=1), full)
    assert full.shape == (3, h, w)


@pytest.mark.parametrize("h,w,sub,ri", [
    (41, 57, "420", 0),    # odd sides, a partial tail stripe
    (64, 48, "422", 7),    # max_v = 1, restart seams inside a stripe
    (129, 96, "444", 11),  # 1x1 sampling, odd height
    (24, 200, "420", 3),   # fewer MCU rows than one stripe
])
def test_stripes_random_geometries(h, w, sub, ri):
    """The JAX package's v2 stripe walk cases: bit-exact to the full
    decode, and within the device contract of the JAX stripe walk."""
    rng = np.random.default_rng(h * 1000 + w)
    img = np.clip(np.linspace(0, 255, w)[None, :, None] + rng.normal(0, 20, (h, w, 3)),
                  0, 255).astype(np.uint8)
    data = jt.encode_rgb(img, 80, subsampling=sub, restart_interval=ri)
    assert jtt.decode(data, sparse_direct=True).packed_mcu2 is not None  # the v2 walk
    got = torch.cat([s for _, s in jtt.decode_rgb_stripes(data, device="cpu",
                                                          stripe_mcu_rows=4)], dim=1)
    assert torch.equal(got, _full(data))
    want = np.concatenate([s for _, s in ref_streaming.decode_rgb_stripes(
        data, stripe_mcu_rows=4, device=False)], axis=1)
    d = np.abs(got.numpy().astype(np.int64) - want)
    assert d.max() <= 2 and (d > 0).mean() <= 1e-4


@pytest.mark.parametrize("rows", [2, 8])
def test_stripes_v1_wire_fallback(rows, monkeypatch):
    """``JPX_WIRE=1`` pins the v1 MCU payload: the walk takes the v1 branch
    and gives the v2 branch's pixels."""
    data = jt.encode_rgb(_image(136, 80, seed=3), 80)
    v2 = _stitch(data, rows)
    monkeypatch.setenv("JPX_WIRE", "1")
    res = jtt.decode(data, sparse_direct=True)
    assert res.packed_mcu is not None and res.packed_mcu2 is None
    v1 = _stitch(data, rows)
    assert len(v1) == len(v2)
    assert all(torch.equal(a, b) for a, b in zip(v1, v2))


def test_streaming_consumer_callback():
    data = jt.encode_rgb(_image(96, 64, seed=4), 80)
    seen = []
    jtt.decode_rgb_streaming(data, lambda y0, s: seen.append((y0, tuple(s.shape))),
                             device="cpu", stripe_mcu_rows=2)
    assert seen == [(0, (3, 32, 64)), (32, (3, 32, 64)), (64, (3, 32, 64))]


def test_to_numpy_gives_host_arrays():
    data = jt.encode_rgb(_image(72, 64, seed=5), 80)
    stripes = _stitch(data, 2, to_numpy=True)
    assert all(isinstance(s, np.ndarray) and s.dtype == np.uint8 for s in stripes)
    np.testing.assert_array_equal(np.concatenate(stripes, axis=1), _full(data).numpy())


@pytest.mark.parametrize("make", [
    lambda: encode_progressive_rgb(_image(64, 64, 6), 85),
    lambda: encode_lossless(_image(32, 48, 7), predictor=1),
], ids=["progressive", "lossless"])
def test_streaming_rejects_non_baseline(make):
    with pytest.raises(ValueError):
        next(jtt.decode_rgb_stripes(make(), device="cpu"))


def test_each_stripe_is_one_transform(monkeypatch):
    """Every stripe is one transform at stripe shape: 3 K1 calls for
    YCbCr, and never more than one stripe's rows."""
    calls = []
    plain = kernels.dequantize_idct_shift
    monkeypatch.setattr(kernels, "dequantize_idct_shift",
                        lambda c, *a, **k: calls.append(c.shape) or plain(c, *a, **k))
    data = jt.encode_rgb(_image(160, 64, seed=8), 80)  # 10 MCU rows
    stripes = _stitch(data, 4)
    assert len(stripes) == 3 and len(calls) == 9
    assert max(shape[1] for shape in calls) == 4 * 2  # Y block rows of one stripe


def test_stripe_payload_is_smaller_than_the_image():
    """The walk's working set, the compact payload and one stripe, is well
    under one RGB image (the JAX package's bounded-memory check)."""
    h, w = 512, 768
    data = jt.encode_rgb(_image(h, w, seed=9), 75)
    res = jtt.decode(data, sparse_direct=True)
    stripe_bytes = 3 * 16 * 8 * res.geometry.max_v * w
    assert res.packed_mcu2.nbytes + stripe_bytes < 3 * h * w


@pytest.mark.parametrize("rows", [1, 4, 16])
@pytest.mark.parametrize("wire", ["v2", "v1"])
def test_stripe_split_equals_jax(rows, wire, monkeypatch):
    """The host copy's stripe split gives the JAX package's payloads,
    geometry, tables and heights."""
    if wire == "v1":
        monkeypatch.setenv("JPX_WIRE", "1")
    data = jt.encode_rgb(_image(200, 120, seed=10), 85, restart_interval=5)
    ours, ref = jtt.decode(data, sparse_direct=True), jt.decode(data, sparse_direct=True)
    split = "split_payload2_stripes" if wire == "v2" else "split_payload_stripes"
    got = getattr(host_streaming, split)(ours, rows)
    want = getattr(ref_streaming, split)(ref, rows)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == ours.geometry and repr(want[1]) == repr(ref.geometry)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]
    sgeo = host_streaming._stripe_geometry(ours.geometry, rows, 16 * rows)
    assert repr(sgeo) == repr(ref_streaming._stripe_geometry(ref.geometry, rows, 16 * rows))


@pytest.mark.parametrize("predictor", [1, 4, 7])
def test_lossless_rows_equal_jax(predictor):
    """Across restart spans that end inside a row: the panels of the
    JAX package's decode_lossless_rows, and the full decode's samples."""
    img = np.random.default_rng(5).integers(0, 256, (53, 41, 3), dtype=np.uint8)
    data = encode_lossless(img, predictor=predictor, restart_interval=37)
    got = list(jtt.models.streaming.decode_lossless_rows(data, mcu_rows=5))
    want = list(ref_streaming.decode_lossless_rows(data, mcu_rows=5))
    assert [y for y, _ in got] == [y for y, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert sorted(a) == sorted(b)
        for ci in a:
            np.testing.assert_array_equal(a[ci], b[ci])
    full = jtt.decode(data)
    for ci, plane in full.samples.items():
        np.testing.assert_array_equal(np.concatenate([p[ci] for _, p in got]), plane)


def test_lossless_rows_reject_lossy():
    with pytest.raises(ValueError):
        next(streaming.decode_lossless_rows(jt.encode_rgb(_image(16, 16, 11), 75)))
