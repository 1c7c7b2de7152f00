"""PyTorch port, the serving decode as a whole on the CPU: held against
the JAX package's device transform (XLA:CPU) and against its host golden
path, under the JAX package's own device contract
(tests/test_device_host_tolerance.py): at most 2 RGB levels (1 sample
LSB through the chroma matrix), on at most 1e-4 of the values."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jpeglibrary_tpu as jt
import jpeglibrary_tpu_torch as jtt


def _gradient_noise(h, w, seed, sigma=30.0):
    rng = np.random.default_rng(seed)
    return np.clip(
        np.linspace(0, 255, w)[None, :, None] + rng.normal(0, sigma, (h, w, 3)), 0, 255
    ).astype(np.uint8)


CASES = {
    "420": lambda: jt.encode_rgb(_gradient_noise(96, 128, 1), 75, subsampling="420"),
    "422": lambda: jt.encode_rgb(_gradient_noise(96, 128, 2), 75, subsampling="422"),
    "444": lambda: jt.encode_rgb(_gradient_noise(96, 128, 3), 75, subsampling="444"),
    "gray": lambda: jt.encode_gray(_gradient_noise(96, 128, 4)[..., 0], 80),
    "q95_444": lambda: jt.encode_rgb(_gradient_noise(96, 128, 5), 95, subsampling="444"),
    "odd_211x333": lambda: jt.encode_rgb(_gradient_noise(211, 333, 6), 75),
    "restart_7": lambda: jt.encode_rgb(_gradient_noise(96, 128, 7), 75, restart_interval=7),
}


def _assert_contract(got, want):
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 2, d.max()
    assert (d > 0).sum() <= d.size * 1e-4, ((d > 0).sum(), d.size)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The stream, the port's host decode of it and the JAX package's."""
    data = CASES[request.param]()
    return data, jtt.decode(data, sparse_direct=True), jt.decode(data, sparse_direct=True)


def test_matches_jax_device_and_host(case):
    _data, res, ref = case
    assert res.packed_mcu2 is not None
    got = jtt.to_rgb8_device(res, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert tuple(got.shape) == (3, res.height, res.width)
    _assert_contract(got.numpy(), np.asarray(ref.to_rgb8_device()))
    _assert_contract(got.numpy(), np.moveaxis(ref.to_rgb8(), -1, 0))


def test_deterministic(case):
    _data, res, _ref = case
    a = jtt.to_rgb8_device(res, device="cpu")
    b = jtt.to_rgb8_device(res, device="cpu")
    assert torch.equal(a, b)


def test_stream_matches_per_image_in_order():
    datas = [CASES[k]() for k in sorted(CASES)]
    want = [jtt.to_rgb8_device(jtt.decode(d, sparse_direct=True), device="cpu") for d in datas]
    got = list(jtt.decode_stream_rgb(datas, device="cpu", depth=2, scan_workers=3))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_transform_mcu2_takes_numpy_inputs():
    res = jtt.decode(CASES["420"](), sparse_direct=True)
    payload, quants = jtt.device_inputs(res, "cpu")
    want = jtt.transform_mcu2(payload, quants, res.geometry, "cpu")
    got = jtt.transform_mcu2(res.packed_mcu2, quants.numpy(), res.geometry, "cpu")
    assert torch.equal(got, want)


def test_guard_lossless():
    res = jtt.decode(jt.encode_lossless(_gradient_noise(32, 48, 8)[..., 0]))
    with pytest.raises(ValueError, match="lossless"):
        jtt.to_rgb8_device(res, device="cpu")


@pytest.mark.parametrize("kwargs", [{"scale": 0.3}, {"upsample": "fancy", "scale": 0.5}])
def test_guard_unported_options(kwargs):
    """An invalid scale raises, and so does fancy upsampling below full
    size, as in the JAX package."""
    res = jtt.decode(CASES["420"](), sparse_direct=True)
    with pytest.raises(ValueError):
        jtt.to_rgb8_device(res, device="cpu", **kwargs)


def test_guard_no_v2_payload():
    """A result without a fused-scan payload (the staged decode's dense
    planes) rides the v1 plane-order wire, within the contract of the JAX
    device path and of the host golden."""
    data = CASES["420"]()
    res, ref = jtt.decode(data), jt.decode(data)
    assert res.packed_mcu2 is None and res.packed_mcu is None
    got = jtt.to_rgb8_device(res, device="cpu")
    assert tuple(got.shape) == (3, res.height, res.width)
    _assert_contract(got.numpy(), np.asarray(ref.to_rgb8_device()))
    _assert_contract(got.numpy(), np.moveaxis(ref.to_rgb8(), -1, 0))


def test_guard_cmyk_stream():
    ink = np.concatenate([_gradient_noise(32, 48, 9), _gradient_noise(32, 48, 10)[..., :1]], -1)
    res = jtt.decode(jt.encode_cmyk(ink, 80), sparse_direct=True)
    assert res.color_transform == "cmyk"
    with pytest.raises(ValueError, match="cmyk"):
        jtt.to_rgb8_device(res, device="cpu")
