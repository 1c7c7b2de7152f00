"""PyTorch port, the JAX package's call forms on the CPU: each entry point
the JAX package calls without naming a device returns in the port too,
held against the JAX package's call.

- The encoders with ``xp=np`` give the bytes of the JAX package's default
  call (its host encoder); with ``xp=torch.device("cpu")`` (the device
  encode's plain versions) the bytes of its ``xp=jnp`` call; so does
  ``JpegEncoder.encode(xp=...)``. Bytes are compared whole.
- The decodes given ``device="cpu"``, or no device with the one resolver
  (``ops._device.default_device``) pointed at the CPU, are within the JAX
  package's device contract of its calls: at most 2 RGB levels on at most
  1e-4 of the values (``tests/test_device_host_tolerance.py``).
- Without a card and without a device, every one of them raises a
  ``RuntimeError`` that names ``device="cpu"``: there is no quiet CPU
  fallback.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import jpeglibrary_tpu as jt
import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu.models.encoder import _configure_rgb_encoder as ref_configure
from jpeglibrary_tpu_torch.host.models.encoder import _configure_rgb_encoder
from jpeglibrary_tpu_torch.ops import _device

CPU = torch.device("cpu")


def _rgb(seed, h=64, w=80):
    rng = np.random.default_rng(seed)
    return np.clip(np.linspace(0, 255, w)[None, :, None] + rng.normal(0, 30, (h, w, 3)),
                   0, 255).astype(np.uint8)


def _ink(seed):
    return np.random.default_rng(seed).integers(0, 256, (40, 56, 4), dtype=np.uint8)


def _contract(got, want):
    """The JAX device contract: at most 2 levels on at most 1e-4 of the values."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 2 and (d > 0).mean() <= 1e-4, (d.max(), (d > 0).mean())


@pytest.fixture
def cpu_default(monkeypatch):
    """The one resolver pointed at the CPU, as if the CPU were the card."""
    monkeypatch.setattr(_device, "default_device", lambda: CPU)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENCODERS = {
    "encode_rgb": (lambda m, **kw: m.encode_rgb(_rgb(1), 80, subsampling="422", **kw)),
    "encode_gray": (lambda m, **kw: m.encode_gray(_rgb(2)[..., 1], 70, **kw)),
    "encode_cmyk": (lambda m, **kw: m.encode_cmyk(_ink(3), 85, ycck=True, **kw)),
    "encode_batch_rgb": (lambda m, **kw: m.encode_batch_rgb([_rgb(4), _rgb(5, 48, 32)], 75,
                                                            **kw)),
}


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_xp_np_equals_jax_default(name):
    """``xp=np`` is the host encoder, the JAX package's default call."""
    call = ENCODERS[name]
    assert call(jtt, xp=np) == call(jt)


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_xp_device_equals_jax_device(name):
    """``xp=torch.device("cpu")`` runs the device encode (K2's plain
    version here), the JAX package's ``xp=jnp`` branch."""
    call = ENCODERS[name]
    want = call(jt, xp=jnp)
    assert call(jtt, xp=CPU) == want
    assert call(jtt, device="cpu") == want
    assert call(jtt, xp=CPU, device="cpu") == want


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_without_device_takes_the_card(name, cpu_default):
    """Neither ``xp`` nor ``device``: the resolver's device, and there the
    device encode (the port's deliberate difference from the JAX default,
    the host)."""
    call = ENCODERS[name]
    assert call(jtt) == call(jt, xp=jnp)


@pytest.mark.parametrize("xp", [np, CPU])
def test_jpeg_encoder_encode_xp(xp):
    """``JpegEncoder.encode(xp=)`` of the host copy: numpy stays the host
    encoder, a torch device runs the port's device encode; each equals the
    JAX package's ``encode(xp=np)`` / ``encode(xp=jnp)``."""
    rgb = _rgb(6)
    ours = _configure_rgb_encoder(90, "420", optimize_coding=True, restart_interval=3)
    ours.set_input_rgb(rgb)
    ref = ref_configure(90, "420", optimize_coding=True, restart_interval=3)
    ref.set_input_rgb(rgb)
    assert ours.encode(xp=xp) == ref.encode(xp=np if xp is np else jnp)
    assert ours.encode() == ref.encode()  # numpy stays the default of the host class


def test_jpeg_encoder_encode_xp_torch_is_the_card(cpu_default):
    rgb = _rgb(7)
    ours = _configure_rgb_encoder(75, "444")
    ours.set_input_rgb(rgb)
    ref = ref_configure(75, "444")
    ref.set_input_rgb(rgb)
    assert ours.encode(xp=torch) == ref.encode(xp=jnp)


@pytest.mark.parametrize("xp", [jnp, "cpu", 0])
def test_encoder_rejects_other_xp(xp):
    with pytest.raises(TypeError, match="xp must be"):
        jtt.encode_rgb(_rgb(8, 16, 16), xp=xp)
    enc = _configure_rgb_encoder(75, "420")
    enc.set_input_rgb(_rgb(8, 16, 16))
    with pytest.raises(TypeError, match="xp must be"):
        enc.encode(xp=xp)


@pytest.mark.parametrize("xp,device", [(np, "cpu"), (CPU, "meta"), (torch.device("cuda"), "cpu")])
def test_encoder_rejects_xp_and_device_that_disagree(xp, device):
    with pytest.raises(ValueError, match="different places"):
        jtt.encode_rgb(_rgb(9, 16, 16), xp=xp, device=device)


def _streams():
    return [jt.encode_rgb(_rgb(10), 75), jt.encode_rgb(_rgb(11), 90, subsampling="444")]


@pytest.mark.parametrize("how", ["device", "resolver"])
def test_decode_stream_rgb_default_call(how, monkeypatch):
    datas = _streams()
    if how == "resolver":
        monkeypatch.setattr(_device, "default_device", lambda: CPU)
        got = list(jtt.decode_stream_rgb(datas))
    else:
        got = list(jtt.decode_stream_rgb(datas, device="cpu"))
    want = list(jt.decode_stream_rgb(datas))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.device == CPU
        _contract(g.numpy(), w)


@pytest.mark.parametrize("how", ["device", "resolver"])
def test_decode_batch_rgb_default_call(how, monkeypatch):
    datas = _streams()
    if how == "resolver":
        monkeypatch.setattr(_device, "default_device", lambda: CPU)
        got = jtt.decode_batch_rgb(datas)
    else:
        got = jtt.decode_batch_rgb(datas, device="cpu")
    want = jt.decode_batch_rgb(datas)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _contract(g, w)


@pytest.mark.parametrize("kwargs", [{}, {"scale": 0.5}, {"upsample": "fancy"},
                                    {"sparse": False}])
def test_to_rgb8_device_method(kwargs, monkeypatch):
    """``decode(b).to_rgb8_device()``: the host copy's method calls the
    port's free function, on the resolver's device or the one named."""
    data = _streams()[0]
    want = jt.decode(data).to_rgb8_device(**kwargs)
    got = jtt.decode(data).to_rgb8_device(device="cpu", **kwargs)
    assert isinstance(got, torch.Tensor) and got.device == CPU
    _contract(got.numpy(), want)
    monkeypatch.setattr(_device, "default_device", lambda: CPU)
    assert torch.equal(jtt.decode(data).to_rgb8_device(**kwargs), got)


CALLS = {
    "encode_rgb": lambda: jtt.encode_rgb(_rgb(12, 16, 16)),
    "encode_gray": lambda: jtt.encode_gray(_rgb(12, 16, 16)[..., 0]),
    "encode_cmyk": lambda: jtt.encode_cmyk(_ink(12)),
    "encode_batch_rgb": lambda: jtt.encode_batch_rgb([_rgb(12, 16, 16)] * 2),
    "encode_rgb xp=torch": lambda: jtt.encode_rgb(_rgb(12, 16, 16), xp=torch),
    "JpegEncoder.encode xp=torch": lambda: _encoder_with_input().encode(xp=torch),
    "decode_stream_rgb": lambda: list(jtt.decode_stream_rgb(_streams())),
    "decode_batch_rgb": lambda: jtt.decode_batch_rgb(_streams()),
    "to_rgb8_device": lambda: jtt.decode(_streams()[0]).to_rgb8_device(),
}


def _encoder_with_input():
    enc = _configure_rgb_encoder(75, "420")
    enc.set_input_rgb(_rgb(12, 16, 16))
    return enc


@pytest.mark.parametrize("name", list(CALLS))
def test_no_card_and_no_device_raises(name, no_card):
    """The resolver never falls back to the CPU: without a card the call
    raises, and the message tells the caller to pass ``device="cpu"``."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CALLS[name]()


def test_resolver():
    if torch.cuda.is_available():
        assert _device.default_device() == torch.device("cuda")
    assert _device.resolve("cpu") == CPU
    assert _device.encode_target(np) is None
    assert _device.encode_target(CPU, "cpu") == CPU
    assert _device.encode_target(None, "cpu") == CPU
