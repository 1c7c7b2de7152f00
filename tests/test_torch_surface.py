"""PyTorch port, the rest of the JAX package's public surface: the host
copies of the region decode, the lossless transcoder and its geometric
transforms, the optimizer, the progressive and hierarchical encoders and
the golden-fixture format give the JAX package's bytes and arrays;
``encode_batch_rgb`` maps the port's device encode; and ``jtt.__all__``
holds the JAX package's public names, each the port's device form where
there is one."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import jpeglibrary_tpu as jt
import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu.models import progressive_encoder as ref_progressive
from jpeglibrary_tpu.utils import fixtures as ref_fixtures
from jpeglibrary_tpu_torch.host.models import progressive_encoder as host_progressive
from jpeglibrary_tpu_torch.host.utils import fixtures as host_fixtures
from jpeglibrary_tpu_torch.models import encoder as port_encoder
from jpeglibrary_tpu_torch.models.decoder import quant_tables
from jpeglibrary_tpu_torch.ops import kernels


def _image(h, w, seed, sigma=20.0):
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, w)[None, :, None] + np.linspace(0, 80, h)[:, None, None]
    return np.clip(base + rng.normal(0, sigma, (h, w, 3)), 0, 255).astype(np.uint8)


STREAMS = {
    "baseline_420": lambda: jt.encode_rgb(_image(77, 133, 1), 80),
    "baseline_444_restart": lambda: jt.encode_rgb(_image(64, 96, 2), 80, subsampling="444",
                                                  restart_interval=3),
    "progressive": lambda: ref_progressive.encode_progressive_rgb(_image(64, 96, 3), 85),
    "arithmetic": lambda: jt.encode_rgb(_image(64, 96, 4), 80, arithmetic=True),
    "gray": lambda: jt.encode_gray(_image(61, 70, 5)[..., 0], 80),
    "lossless": lambda: jt.encode_lossless(_image(40, 56, 6)),
    "cmyk": lambda: jt.encode_cmyk(np.concatenate([_image(32, 48, 7),
                                                   _image(32, 48, 8)[..., :1]], -1), 80),
}


@pytest.fixture(scope="module", params=sorted(STREAMS))
def stream(request):
    return request.param, STREAMS[request.param]()


@pytest.mark.parametrize("rect", [(0, 0, 16, 16), (5, 9, 37, 21), (17, 3, 30, 25)])
def test_decode_region_equals_jax(stream, rect):
    _name, data = stream
    x, y, w, h = rect
    got = jtt.decode_region(data, x, y, w, h)
    want = jt.decode_region(data, x, y, w, h)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_decode_region_fancy_equals_jax():
    data = STREAMS["baseline_420"]()
    np.testing.assert_array_equal(jtt.decode_region(data, 3, 4, 50, 40, upsample="fancy"),
                                  jt.decode_region(data, 3, 4, 50, 40, upsample="fancy"))


@pytest.mark.parametrize("mode", ["optimized", "optimal", "progressive", "arithmetic",
                                  "arithmetic-progressive"])
def test_transcode_equals_jax(mode):
    for name in ("baseline_420", "gray", "progressive"):
        data = STREAMS[name]()
        assert jtt.transcode(data, mode) == jt.transcode(data, mode), (name, mode)


def test_transcode_lossless_and_restart_equal_jax():
    data = STREAMS["lossless"]()
    assert jtt.transcode(data, "arithmetic") == jt.transcode(data, "arithmetic")
    assert jtt.transcode(data, predictor=4) == jt.transcode(data, predictor=4)
    data = STREAMS["baseline_420"]()
    assert (jtt.transcode(data, restart_interval=2, grayscale=True)
            == jt.transcode(data, restart_interval=2, grayscale=True))


@pytest.mark.parametrize("op", ["rot90", "rot180", "rot270", "fliph", "flipv", "transpose",
                                "transverse"])
def test_transform_equals_jax(op):
    data = jt.encode_rgb(_image(64, 96, 9), 80)  # whole iMCUs: every op applies
    got = jtt.transform(data, op)
    assert got == jt.transform(data, op)
    assert got != data


def test_transform_trim_equals_jax():
    data = STREAMS["baseline_420"]()  # 77 x 133: partial iMCUs
    for op in ("rot90", "fliph"):
        assert jtt.transform(data, op, trim=True) == jt.transform(data, op, trim=True)


@pytest.mark.parametrize("snap", [False, True])
def test_crop_equals_jax(snap):
    data = STREAMS["baseline_420"]()
    x, y = (16, 32) if not snap else (5, 7)
    assert jtt.crop(data, x, y, 40, 30, snap=snap) == jt.crop(data, x, y, 40, 30, snap=snap)


def _with_orientation(data, orientation):
    """``data`` with an EXIF APP1 segment whose one tag is the orientation."""
    tiff = (b"II*\x00" + (8).to_bytes(4, "little") + (1).to_bytes(2, "little")
            + (0x0112).to_bytes(2, "little") + (3).to_bytes(2, "little")
            + (1).to_bytes(4, "little") + orientation.to_bytes(2, "little") + b"\x00\x00"
            + (0).to_bytes(4, "little"))
    payload = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload + data[2:]


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_autorotate_equals_jax(orientation):
    data = _with_orientation(jt.encode_rgb(_image(64, 96, 10), 80), orientation)
    got = jtt.autorotate(data)
    assert got == jt.autorotate(data)
    if orientation != 1:
        assert jtt.decode(got).width == (64 if orientation in (6, 8) else 96)


@pytest.mark.parametrize("name", ["baseline_420", "baseline_444_restart", "gray"])
def test_optimize_equals_jax(name):
    data = STREAMS[name]()
    got = jtt.optimize(data)
    assert got == jt.optimize(data)
    opt = jtt.JpegOptimizer()
    opt.set_input(data)
    opt.scan()
    ref = jt.JpegOptimizer()
    ref.set_input(data)
    ref.scan()
    assert opt.optimize(strip=False) == ref.optimize(strip=False)


def test_optimize_refuses_what_jax_refuses():
    data = STREAMS["progressive"]()
    outcomes = []
    for optimize in (jt.optimize, jtt.optimize):
        with pytest.raises(ValueError) as info:
            optimize(data)
        outcomes.append(str(info.value))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("kw", [{}, {"subsampling": "444"}, {"arithmetic": True}],
                         ids=["420", "444", "arithmetic"])
def test_progressive_encoder_equals_jax(kw):
    rgb = _image(50, 70, 11)
    assert (host_progressive.encode_progressive_rgb(rgb, 80, **kw)
            == ref_progressive.encode_progressive_rgb(rgb, 80, **kw))
    gray = rgb[..., 0]
    assert (host_progressive.encode_progressive_gray(gray, 80)
            == ref_progressive.encode_progressive_gray(gray, 80))


@pytest.mark.parametrize("kw", [{}, {"base": "dct", "refinement": "lossless"},
                                {"arithmetic": True, "levels": 2}],
                         ids=["lossless", "dct_base", "arithmetic"])
def test_encode_hierarchical_equals_jax(kw):
    planes = [_image(48, 64, 12)[..., 0]]
    got = jtt.encode_hierarchical(planes, **kw)
    assert got == jt.encode_hierarchical(planes, **kw)
    np.testing.assert_array_equal(jtt.decode(got).to_uint8(), jt.decode(got).to_uint8())


def test_fixture_format_equals_jax(tmp_path):
    """The u16 output written and read back in the golden-fixture format
    (two RGBA PNGs) by the host copy, as the JAX package's does."""
    from PIL import Image

    data = jt.encode_rgb(_image(40, 56, 13), 85)
    res = jtt.decode(data, sparse_direct=True)
    u16 = jtt.transform_mcu2(res.packed_mcu2, quant_tables(res), res.geometry, "cpu",
                             output="u16").numpy()
    pair = host_fixtures.split_to_fixture(u16)
    for got, want in zip(pair, ref_fixtures.split_to_fixture(u16)):
        np.testing.assert_array_equal(got, want)
    asset = str(tmp_path / "x.jpg")
    Image.fromarray(pair[0], "RGBA").save(asset + ".high.png")
    Image.fromarray(pair[1], "RGBA").save(asset + ".low-diff.png")
    loaded = host_fixtures.load_expected_buffer(asset, 3)
    np.testing.assert_array_equal(loaded, ref_fixtures.load_expected_buffer(asset, 3))
    np.testing.assert_array_equal(loaded[..., :3], u16)


def test_encode_batch_rgb_maps_the_device_encode(monkeypatch):
    """Each image is the port's encode_rgb on the device asked for (3 K2
    calls); against the JAX package's encode_batch_rgb(xp=jnp) the bytes
    are equal where the coefficient planes are."""
    calls = []
    plain = kernels.fdct_quantize
    monkeypatch.setattr(kernels, "fdct_quantize",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    rgbs = [_image(40 + 8 * i, 56, 20 + i) for i in range(4)]
    got = jtt.encode_batch_rgb(rgbs, 80, device="cpu", subsampling="422")
    assert len(calls) == 3 * len(rgbs)
    assert got == [jtt.encode_rgb(r, 80, device="cpu", subsampling="422") for r in rgbs]
    assert jtt.encode_batch_rgb(rgbs, 80, device="cpu", max_workers=2,
                                subsampling="422") == got
    want = jt.encode_batch_rgb(rgbs, 80, subsampling="422", xp=jnp)
    for g, w, rgb in zip(got, want, rgbs):
        if g != w:  # a coefficient within one of the JAX package's: decode both
            a, b = jt.decode(g), jt.decode(w)
            for c in b.geometry.components:
                d = np.abs(a.coefficients[c.component_index].astype(int)
                           - b.coefficients[c.component_index])
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    assert jtt.encode_batch_rgb([], device="cpu") == []


# The JAX package's public names; the port has all but the XLA compile cache.
JAX_NAMES = sorted(set(jt.__all__) - {"enable_compile_cache"})


@pytest.mark.parametrize("name", JAX_NAMES)
def test_public_name_exported(name):
    assert name in jtt.__all__
    assert callable(getattr(jtt, name))


def test_device_forms_exported():
    assert "enable_compile_cache" not in jtt.__all__
    assert jtt.encode_cmyk is port_encoder.encode_cmyk
    assert jtt.encode_rgb is port_encoder.encode_rgb
    assert jtt.encode_batch_rgb.__module__ == "jpeglibrary_tpu_torch.parallel.batch"
    assert jtt.decode_rgb_stripes.__module__ == "jpeglibrary_tpu_torch.models.streaming"
    assert len(jtt.__all__) == len(set(jtt.__all__))
    assert all(hasattr(jtt, n) for n in jtt.__all__)
    # The host copies carry the JAX names: none of them is the JAX package's object.
    for name in JAX_NAMES:
        assert getattr(jtt, name) is not getattr(jt, name), name
        assert getattr(jtt, name).__module__.startswith("jpeglibrary_tpu_torch."), name
