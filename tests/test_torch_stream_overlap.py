"""PyTorch port, the stream's device workers on the CPU: with
``device_workers=2`` ``decode_stream_rgb`` gives what it gives with one
worker, bit for bit, and what the JAX package's ``decode_stream_rgb``
gives within the JAX device contract (at most 2 RGB levels on at most
1e-4 of the values; scaled, 2 levels on under 5%), at groups 1, 3 and 8,
at every scale, on a stream of one geometry and on one that mixes two
geometries and a lossless image. A slow consumer gets every image in
order, each still equal to its single-image decode when the stream has
ended. The CPU path stages nothing and pins nothing; on the card each
worker stages its group's arrays in one pinned buffer (the layout is
checked here), and a stream or pinning failure raises. The kernels'
launch counters lose no count when 8 threads count at once."""

import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jpeglibrary_tpu as jt
import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu_torch.ops import kernels
from jpeglibrary_tpu_torch.parallel import batch as port_batch

from torch_reference_native import settle

settle()  # the JAX package's native scanner, built once before any test

SCALES = [1.0, 0.5, 0.25, 0.125]


def _image(h, w, seed, sigma=18.0):
    rng = np.random.default_rng(seed)
    return np.clip(
        np.linspace(0, 255, w)[None, :, None] + np.linspace(0, 60, h)[:, None, None]
        + rng.normal(0, sigma, (h, w, 3)), 0, 255,
    ).astype(np.uint8)


@pytest.fixture(scope="module")
def uniform():
    """8 images of one geometry, each with its own quant tables."""
    return [jt.encode_rgb(_image(80, 96, 40 + i), q)
            for i, q in enumerate((90, 50, 25, 75, 60, 85, 40, 70))]


@pytest.fixture(scope="module")
def mixed():
    """Two geometries (4:2:0 80x96, 4:4:4 72x104) and a lossless image."""
    a = [jt.encode_rgb(_image(80, 96, 50 + i), 75) for i in range(3)]
    b = [jt.encode_rgb(_image(72, 104, 60 + i), 80, subsampling="444") for i in range(2)]
    lossless = jt.encode_lossless(_image(40, 56, 70))
    return [a[0], b[0], a[1], lossless, a[2], b[1]]


def _port(datas, **kwargs):
    return [t.numpy() for t in jtt.decode_stream_rgb(datas, device="cpu", **kwargs)]


def _assert_contract(got, want, scaled):
    got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 2, d.max()
    if scaled:
        assert (d > 0).mean() < 0.05, (d > 0).mean()
    else:
        assert (d > 0).sum() <= d.size * 1e-4, (d > 0).sum()


def _single(data):
    """The port's single-image decode, planar; the host writer for lossless."""
    res = jtt.decode(data, sparse_direct=True)
    if res.samples is not None:
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(res.to_rgb8(), -1, 0)))
    res.prepack()
    return jtt.to_rgb8_device(res, device="cpu")


def _held_to_one_worker_and_jax(datas, group, scale):
    one = _port(datas, group=group, scale=scale, device_workers=1)
    two = _port(datas, group=group, scale=scale, device_workers=2, depth=2)
    want = [np.asarray(x) for x in jt.decode_stream_rgb(datas, group=group, scale=scale)]
    assert len(one) == len(two) == len(want) == len(datas)
    for a, b, w in zip(one, two, want):
        np.testing.assert_array_equal(b, a)
        _assert_contract(b, w, scale != 1.0)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("group", [1, 3, 8])
def test_two_workers_equal_one_and_jax(uniform, group, scale):
    _held_to_one_worker_and_jax(uniform, group, scale)


@pytest.mark.parametrize("scale", [1.0, 0.25])
@pytest.mark.parametrize("group", [1, 3, 8])
def test_two_workers_on_mixed_stream(mixed, group, scale):
    _held_to_one_worker_and_jax(mixed, group, scale)


@pytest.mark.parametrize("group", [1, 3])
def test_slow_consumer_keeps_order_and_images(uniform, mixed, group):
    """The consumer sleeps between images while two workers run ahead (as
    far as ``depth`` lets them); every image comes in input order, and
    after the stream has ended each still equals its single-image decode:
    no later group wrote into an image already handed on."""
    datas = mixed + uniform[:4]
    outs = []
    for t in jtt.decode_stream_rgb(datas, device="cpu", device_workers=2, depth=2,
                                   group=group, scan_workers=4):
        outs.append(t)
        time.sleep(0.02)
    assert len(outs) == len(datas)
    for got, data in zip(outs, datas):
        assert torch.equal(got, _single(data))


def test_cpu_path_stages_and_pins_nothing(monkeypatch, uniform, mixed):
    calls = []
    monkeypatch.setattr(port_batch, "_pinned", lambda n: calls.append(("pinned", n)))
    monkeypatch.setattr(port_batch, "_Uploader", lambda *a: calls.append(("uploader", a)))
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda self, *a, **k: calls.append(("pin_memory",)))
    outs = list(jtt.decode_stream_rgb(uniform[:3] + mixed, device="cpu", device_workers=2,
                                      group=3))
    assert len(outs) == 3 + len(mixed) and calls == []


def test_no_card_raises_the_resolvers_error(monkeypatch, uniform):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        next(jtt.decode_stream_rgb(uniform[:2]))


class _FakeStreamContext:
    def __init__(self, stream):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("fails", ["stream", "pin"])
def test_stream_or_pin_failure_raises(monkeypatch, uniform, fails):
    """A device worker whose stream or pinned buffer cannot be made raises
    from the stream; it does not go on synchronously."""
    def refuse(*args, **kwargs):
        raise RuntimeError(f"refused {fails}")

    if fails == "stream":
        monkeypatch.setattr(torch.cuda, "Stream", refuse)
    else:
        monkeypatch.setattr(torch.cuda, "Stream", lambda device: object())
        monkeypatch.setattr(torch.cuda, "stream", _FakeStreamContext)
        monkeypatch.setattr(port_batch, "_pinned", refuse)
    with pytest.raises(RuntimeError, match=f"refused {fails}"):
        list(jtt.decode_stream_rgb(uniform[:3], device="cuda", device_workers=2))


def test_staged_layout_round_trips():
    """A group's arrays (a v2 wire, a v1 wire, quant tables, a lossless
    image) laid into one byte buffer at 16-byte offsets and viewed back
    with their dtypes and shapes."""
    rng = np.random.default_rng(7)
    arrays = [rng.integers(0, 256, 37, dtype=np.uint8),
              rng.integers(-300, 300, (2, 9), dtype=np.int16),
              rng.integers(1, 255, (3, 64), dtype=np.int32),
              rng.integers(0, 256, (3, 5, 7), dtype=np.uint8)]
    offsets, total = port_batch._staged_layout(arrays)
    assert offsets == [0, 48, 96, 864] and total == 864 + 105
    flat = torch.full((total + 5,), 0xAB, dtype=torch.uint8)
    port_batch._stage(flat.numpy(), arrays, offsets)
    views = port_batch._unstage(flat[:total], arrays, offsets)
    for a, v in zip(arrays, views):
        assert v.dtype == torch.from_numpy(a).dtype and tuple(v.shape) == a.shape
        np.testing.assert_array_equal(v.numpy(), a)
        assert v.storage_offset() * v.element_size() % port_batch.STAGING_ALIGN == 0


def test_launch_counts_lose_nothing_across_threads():
    """8 threads count 4,000 launches each on one wrapper's counters,
    through the bookkeeping every kernel wrapper uses, with the interpreter
    switching threads as often as it can: no count is lost."""
    def wrapper():
        pass

    wrapper.launches, wrapper.launches_by_box = 0, {}
    n, box = 4000, (torch.uint8, 2, 2)

    def count():
        for i in range(n):
            kernels.count_launch(wrapper, box=box, rounds=i)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 8 * n and wrapper.launches_by_box == {box: 8 * n}
    assert wrapper.rounds == n - 1
