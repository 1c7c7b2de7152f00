"""PyTorch port, K6 (``kernels.color_round_trip``, ``csrc/color_round_trip.cu``)
on the CPU, at 4:2:0 and 4:2:2: its wrapper takes the plain version there
(``color.round_trip_plain``, the step's colour ops one by one); a
model of the kernel in numpy (its index arithmetic and its folded
constants, step by step as the source has them, at either MCU height)
must equal it byte for byte; every (Y, Cb, Cr) byte triple goes
through the round trip once, against the JAX package's colour functions;
the wrapper refuses what the kernel does not take; ``_step`` gives the same
outputs with the plain version and with the model, and those of the JAX
``full_step``; ``chip_smoke.py``'s K6 phase runs end to end on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` and
``tests/test_torch_color_round_trip_card.py`` hold it to the plain version
there, 0 bytes differing)."""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from jpeglibrary_tpu.ops import color as ref_color
from jpeglibrary_tpu.ops import decode_stage as ref_decode_stage
from jpeglibrary_tpu.parallel import sharding as ref_sharding
from jpeglibrary_tpu.syntax.quantization import (
    STANDARD_CHROMINANCE_ZIGZAG,
    STANDARD_LUMINANCE_ZIGZAG,
)

from jpeglibrary_tpu_torch.ops import color, kernels
from jpeglibrary_tpu_torch.parallel import sharding

from torch_reference_native import settle

settle()  # the JAX package's native scanner, built once before any test

ROOT = pathlib.Path(__file__).resolve().parent.parent
KERNEL_STRIP = 16  # csrc/color_round_trip.cu's strip: kMcus = KERNEL_STRIP / VS MCUs


def _reference_chain(y, cb, cr):
    """The JAX ``full_step``'s decode tail and colour round trip, its ops
    with ``xp=np`` on numpy int32 samples, the chroma duplicated by the
    luma's block rows and columns over its own: (rgb, y', cb', cr') uint8."""
    def plane(s, up):
        p = s.transpose(0, 1, 3, 2, 4).reshape(s.shape[0], s.shape[1] * 8, s.shape[2] * 8)
        return np.repeat(np.repeat(p, up[1], axis=1), up[0], axis=2)

    up = (y.shape[2] // cb.shape[2], y.shape[1] // cb.shape[1])
    y8, cb8, cr8 = (ref_decode_stage.clamp_to_uint8(plane(s, u), xp=np)
                    for s, u in ((y, (1, 1)), (cb, up), (cr, up)))
    r, g, b = ref_color.ycbcr_to_rgb(y8, cb8, cr8, xp=np)
    return (np.stack([r, g, b], axis=-1), *ref_color.rgb_to_ycbcr(r, g, b, xp=np))


def _convert(y, cb, cr):
    """The kernel's arithmetic on int32 arrays of the same shape (each
    pixel's own chroma samples): (R, G, B, y', cb', cr') uint8, each of the
    last three byte 2 of its sum."""
    c = [np.int32(v) for v in color.ROUND_TRIP_CONSTANTS]
    y, cb, cr = (np.clip(v, 0, 255).astype(np.int32) for v in (y, cb, cr))
    cr_r = (c[0] * cr + c[1]) >> 16
    cb_b = (c[2] * cb + c[3]) >> 16
    g_off = (c[4] * cb + c[5] * cr + c[6]) >> 16
    r, g, b = (np.clip(y + d, 0, 255).astype(np.int32) for d in (cr_r, g_off, cb_b))
    sums = (c[7] * r + c[8] * g + c[9] * b + c[10],
            c[11] * r + c[12] * g + c[13] * b + c[14],
            c[13] * r + c[15] * g + c[16] * b + c[14])
    return (*(v.astype(np.uint8) for v in (r, g, b)),
            *(((s >> 16) & 255).astype(np.uint8) for s in sums))


def _pad_to(words, mod32):
    return words + ((mod32 - words % 32) + 32) % 32


def _kernel_model(y, cb, cr):
    """``color_round_trip_kernel<VS>`` in numpy, CTA by CTA, its threads as
    arrays: the same chunk loads, shared-memory offsets, staged rows and
    store loop, VS (the MCU's height in blocks) the luma's block rows over
    the chroma's. int32 numpy samples -> (rgb, y', cb', cr') as the wrapper
    returns them."""
    b, hb, wb = y.shape[:3]
    vs = hb // cb.shape[1]
    rows = 8 * vs  # luma rows of an MCU
    mcus = KERNEL_STRIP // vs  # MCUs of a CTA's strip
    wm, mcu_rows = wb // 2, b * hb // vs
    strips = -(-wm // mcus)
    width = 16 * wm
    y4, cb4, cr4 = (s.reshape(-1, 4) for s in (y, cb, cr))
    rgb = np.zeros((mcu_rows * rows, width * 3), np.uint8)
    planes = np.zeros((3, mcu_rows * rows, width), np.uint8)
    rgb_pitch, plane_pitch = 4 * _pad_to(12 * mcus, 12), 4 * _pad_to(4 * mcus, 4)
    for blk in range(mcu_rows * strips):
        m, mcu0 = blk // strips, (blk % strips) * mcus
        n = min(mcus, wm - mcu0)
        threads = np.arange(32 * mcus)
        s_chroma = np.zeros((2, mcus * 16, 4), np.int32)
        comp = threads // (16 * mcus)
        i = threads - comp * 16 * mcus
        for c_, src in enumerate((cb4, cr4)):
            sel = (comp == c_) & (i < 16 * n)
            s_chroma[c_][i[sel]] = src[(m * wm + mcu0) * 16 + i[sel]]
        s_chroma = s_chroma.reshape(2, -1)
        s_rgb = np.zeros((rows, rgb_pitch), np.uint8)
        s_plane = np.zeros((3, rows, plane_pitch), np.uint8)
        t = threads[threads < 32 * n]
        bb, q = t // 16, t % 16
        col = bb * 8 + (q % 2) * 4
        chroma_col = (bb // 2) * 64 + (bb % 2) * 4 + (q % 2) * 2
        for r in range(vs):
            luma = y4[((vs * m + r) * 2 * wm + 2 * mcu0) * 16 + t]
            row = r * 8 + q // 2
            at = (chroma_col + (row // vs) * 8)[:, None] + np.array([0, 0, 1, 1])
            out = _convert(luma, s_chroma[0][at], s_chroma[1][at])
            s_rgb[row[:, None], 3 * col[:, None] + np.arange(12)] = np.stack(
                out[:3], -1).reshape(-1, 12)
            for p, v in enumerate(out[3:]):
                s_plane[p, row[:, None], col[:, None] + np.arange(4)] = v
        row0, col0 = rows * m, 16 * mcu0
        rgb_chunks = 3 * n
        for i in range(rows * rgb_chunks + 3 * rows * n):  # every thread's chunks
            if i < rows * rgb_chunks:
                row, c = i // rgb_chunks, i % rgb_chunks
                rgb[row0 + row, col0 * 3 + 16 * c:col0 * 3 + 16 * c + 16] = \
                    s_rgb[row, 16 * c:16 * c + 16]
            else:
                j = i - rows * rgb_chunks
                plane = j // (rows * n)
                row = (j - plane * rows * n) // n
                c = j - (plane * rows + row) * n
                planes[plane, row0 + row, col0 + 16 * c:col0 + 16 * c + 16] = \
                    s_plane[plane, row, 16 * c:16 * c + 16]
    h = hb * 8
    return (torch.from_numpy(rgb.reshape(b, h, width, 3)),
            *(torch.from_numpy(p.reshape(b, h, width)) for p in planes))


def _model_k6(y, cb, cr):
    """:func:`_kernel_model` as a ``k6`` of ``_step``."""
    return _kernel_model(*(s.numpy() for s in (y, cb, cr)))


def _samples(b, hb, wb, seed, vs=2):
    """K1-range samples (-300 to 400) of a 4:2:0 (``vs`` 2) or 4:2:2 (1)
    batch, with the int32 extremes and the clamp's edges planted in each
    component."""
    rng = np.random.default_rng(seed)
    out = []
    chroma = (b, hb // vs, wb // 2, 8, 8)
    for shape in ((b, hb, wb, 8, 8), chroma, chroma):
        x = rng.integers(-300, 401, size=shape, dtype=np.int32)
        edges = np.array([-2**31, 2**31 - 1, -1, 0, 255, 256], np.int32)
        x.reshape(-1)[rng.choice(x.size, edges.size, replace=False)] = edges
        out.append(torch.from_numpy(x))
    return out


# (batch, luma block rows, luma block columns): the benchmark cells' images
# cut to 2 and 1 MCU rows (512 and 64 luma blocks a row), and MCU rows of 1,
# 5 and 33 MCUs (the last strip of a row ragged), at batch 1 and 3.
SHAPES = [(1, 4, 512), (3, 2, 64), (1, 2, 2), (3, 4, 2), (1, 6, 10), (3, 2, 10), (1, 2, 66),
          (3, 4, 66)]
# 4:2:2 batches (MCU rows of one block row): odd MCU rows, MCU rows of 1, 5,
# 33 and 375 MCUs (the 24 MP cell's width: 23 whole strips of 16 MCUs and a ragged 7).
SHAPES_422 = [(1, 3, 512), (3, 1, 64), (1, 1, 2), (3, 5, 2), (2, 3, 10), (1, 7, 66),
              (2, 2, 750)]
CASES = [(*s, 2) for s in SHAPES] + [(*s, 1) for s in SHAPES_422]
IDS = ["x".join(map(str, s)) for s in SHAPES] + ["422-" + "x".join(map(str, s))
                                                 for s in SHAPES_422]


@pytest.mark.parametrize("shape", CASES, ids=IDS)
def test_wrapper_on_the_cpu_equals_the_chain(shape):
    """The wrapper (the plain version on the CPU) equals the JAX step's
    decode tail and colour round trip byte for byte, the chroma duplicated
    2x2 (4:2:0) or 2x1 (4:2:2)."""
    samples = _samples(*shape[:3], seed=sum(shape[:3]), vs=shape[3])
    got = kernels.color_round_trip(*samples)
    for g, w in zip(got, _reference_chain(*(s.numpy() for s in samples))):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("shape", CASES, ids=IDS)
def test_kernel_model_equals_the_plain_version(shape):
    """The kernel's model equals the wrapper, which takes the plain
    version on the CPU: the RGB [B, H, W, 3] and the three planes [B, H,
    W], uint8 and contiguous."""
    samples = _samples(*shape[:3], seed=7 * sum(shape[:3]), vs=shape[3])
    got = kernels.color_round_trip(*samples)
    b, hb, wb = shape[:3]
    assert [tuple(g.shape) for g in got] == [(b, hb * 8, wb * 8, 3)] + [(b, hb * 8, wb * 8)] * 3
    for g, w in zip(_model_k6(*samples), got):
        assert w.dtype == torch.uint8 and w.is_contiguous() and torch.equal(g, w)


def test_samples_outside_the_byte_range_clamp():
    """Samples far outside [0, 255] give the RGB and planes of their clamped
    values."""
    b, hb, wb = 1, 2, 2
    y = torch.full((b, hb, wb, 8, 8), -300, dtype=torch.int32)
    y[..., 1::2] = 400
    cb = torch.full((b, hb // 2, wb // 2, 8, 8), 400, dtype=torch.int32)
    cr = torch.full((b, hb // 2, wb // 2, 8, 8), -300, dtype=torch.int32)
    clamped = [s.clamp(0, 255) for s in (y, cb, cr)]
    want = color.round_trip_plain(*clamped)
    for g, w in zip(kernels.color_round_trip(y, cb, cr), want):
        assert torch.equal(g, w)
    for g, w in zip(_model_k6(y, cb, cr), want):
        assert torch.equal(g, w)


TRIPLE_CHUNKS = 4


@pytest.mark.parametrize("chunk", range(TRIPLE_CHUNKS))
def test_every_byte_triple_once(chunk):
    """A quarter of the 2^24 (Y, Cb, Cr) triples a test: image k of 16 holds
    Cb = i and Cr = j in chroma cell (i, j) of a 256 x 256 chroma plane, and
    the four luma pixels of the cell the Y values 4k' + 2a + b (k' = k + 16
    chunk). The wrapper's outputs equal the JAX package's
    ``ycbcr_to_rgb`` and ``rgb_to_ycbcr`` of each triple, as does the
    kernel's arithmetic (:func:`_convert`)."""
    n = 64 // TRIPLE_CHUNKS
    k = np.arange(n * chunk, n * (chunk + 1), dtype=np.int32)
    ab = np.arange(4, dtype=np.int32).reshape(2, 2)
    y_plane = 4 * k[:, None, None, None, None] + ab[None, None, :, None, :]  # [n, 1, 2, 1, 2]
    y_plane = np.broadcast_to(y_plane, (n, 256, 2, 256, 2)).reshape(n, 512, 512)
    cb_plane = np.broadcast_to(np.arange(256, dtype=np.int32)[:, None], (n, 256, 256))
    cr_plane = np.broadcast_to(np.arange(256, dtype=np.int32)[None, :], (n, 256, 256))

    def blocks(p):  # [n, H, W] -> K1's [n, H/8, W/8, 8, 8]
        return torch.from_numpy(np.ascontiguousarray(
            p.reshape(n, p.shape[1] // 8, 8, p.shape[2] // 8, 8).transpose(0, 1, 3, 2, 4)))

    got = kernels.color_round_trip(blocks(y_plane), blocks(cb_plane), blocks(cr_plane))
    y8 = y_plane.astype(np.uint8)
    cb8, cr8 = (np.repeat(np.repeat(p, 2, 1), 2, 2).astype(np.uint8) for p in (cb_plane, cr_plane))
    r, g, b = ref_color.ycbcr_to_rgb(y8, cb8, cr8)
    want = (np.stack([r, g, b], -1), *ref_color.rgb_to_ycbcr(r, g, b))
    for gt, w in zip(got, want):
        assert np.array_equal(gt.numpy(), w)
    model = _convert(y_plane, np.repeat(np.repeat(cb_plane, 2, 1), 2, 2),
                     np.repeat(np.repeat(cr_plane, 2, 1), 2, 2))
    assert np.array_equal(np.stack(model[:3], -1), want[0])
    for m_, w in zip(model[3:], want[1:]):
        assert np.array_equal(m_, w)


def _good(b=1, hb=2, wb=2):
    return [torch.zeros(shape, dtype=torch.int32) for shape in
            ((b, hb, wb, 8, 8), (b, hb // 2, wb // 2, 8, 8), (b, hb // 2, wb // 2, 8, 8))]


@pytest.mark.parametrize("case", ["int16", "non-contiguous", "unaligned", "odd Hb", "odd Wb",
                                  "chroma not half", "cb and cr differ", "flat blocks",
                                  "1x2", "4x1", "422 odd Wb", "420 Cb and 422 Cr",
                                  "422 Cb and 420 Cr"])
def test_wrapper_refuses(case):
    """Shapes K6 does not take raise: the chroma at (1, 1) ("chroma not
    half"), (1, 2) and (4, 1), Cb and Cr of two samplings, 4:2:2 with an
    odd Wb; and samples of another type, layout or alignment."""
    y, cb, cr = _good()
    error = ValueError
    if case == "int16":
        y, error = y.to(torch.int16), TypeError
    elif case == "non-contiguous":
        y = _good(wb=4)[0][:, :, ::2]
    elif case == "unaligned":  # contiguous, 4 bytes past a 16-byte boundary
        y = torch.zeros(y.numel() + 4, dtype=torch.int32)[1:1 + y.numel()].view(y.shape)
    elif case == "odd Hb":
        y = torch.zeros((1, 3, 2, 8, 8), dtype=torch.int32)
    elif case == "odd Wb":
        y = torch.zeros((1, 2, 3, 8, 8), dtype=torch.int32)
    elif case == "chroma not half":
        cb = cr = torch.zeros((1, 2, 2, 8, 8), dtype=torch.int32)
    elif case == "cb and cr differ":
        cr = torch.zeros((1, 1, 2, 8, 8), dtype=torch.int32)
    elif case == "flat blocks":
        y = y.reshape(1, 2, 2, 64)
    elif case == "1x2":  # the chroma halved down only
        cb = cr = torch.zeros((1, 1, 2, 8, 8), dtype=torch.int32)
    elif case == "4x1":
        y = torch.zeros((1, 2, 4, 8, 8), dtype=torch.int32)
        cb = cr = torch.zeros((1, 2, 1, 8, 8), dtype=torch.int32)
    elif case == "422 odd Wb":
        y = torch.zeros((1, 2, 3, 8, 8), dtype=torch.int32)
        cb = cr = torch.zeros((1, 2, 1, 8, 8), dtype=torch.int32)
    elif case == "420 Cb and 422 Cr":
        cr = torch.zeros((1, 2, 1, 8, 8), dtype=torch.int32)
    elif case == "422 Cb and 420 Cr":
        cb = torch.zeros((1, 2, 1, 8, 8), dtype=torch.int32)
    with pytest.raises(error, match=None if error is TypeError or case in (
            "non-contiguous", "unaligned", "flat blocks") else "4:2:0|4:2:2|differ"):
        kernels.color_round_trip(y, cb, cr)


def test_kernel_source_is_bound():
    """``csrc/color_round_trip.cu`` defines the entry point the loader binds,
    with as many parameters as its ctypes signature, and its constants are
    as many as ``color.ROUND_TRIP_CONSTANTS``."""
    import re

    from jpeglibrary_tpu_torch.ops import _build

    text = (_build._CSRC / "color_round_trip.cu").read_text()
    m = re.search(r'extern "C" int jpx_color_round_trip\(([^)]*)\)', text)
    assert m and m.group(1).count(",") + 1 == len(_build._ENTRY_POINTS["jpx_color_round_trip"])
    assert f"constexpr int kConstants = {len(color.ROUND_TRIP_CONSTANTS)};" in text
    assert f"static constexpr int kMcus = {KERNEL_STRIP} / VS;" in text


def _example_args(batch=2, hb=8, wb=16, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(-64, 64, size=(batch, hb, wb, 64), dtype=np.int16)
    cb = rng.integers(-32, 32, size=(batch, hb // 2, wb // 2, 64), dtype=np.int16)
    cr = rng.integers(-32, 32, size=(batch, hb // 2, wb // 2, 64), dtype=np.int16)
    return (y, cb, cr, STANDARD_LUMINANCE_ZIGZAG.astype(np.int32),
            STANDARD_CHROMINANCE_ZIGZAG.astype(np.int32))


@pytest.mark.parametrize("args", [(2, 8, 16, 0), (3, 4, 34, 1)], ids=["2x8x16", "3x4x34"])
def test_step_with_the_plain_version_and_the_model(args):
    """``_step`` with ``k6`` the plain version, and with the kernel's model,
    gives ``full_step``'s outputs, whose RGB and requantised luma match the
    JAX ``full_step``'s (the tolerance of ``tests/test_torch_full_step.py``)."""
    inputs = _example_args(*args)
    rgb, requant, hists = sharding.full_step(*inputs, device="cpu")
    tensors = sharding._step_inputs(*inputs, "cpu")
    for k6 in (color.round_trip_plain, _model_k6):
        got_rgb, got_requants, got_hists = sharding._step(
            *tensors, kernels.dequantize_idct_shift, kernels.fdct_quantize, k6=k6)
        assert torch.equal(got_rgb, rgb) and torch.equal(got_requants[0], requant)
        assert torch.equal(got_hists, hists)
    want_rgb, want_requant, want_hists = (np.asarray(x) for x in
                                          jax.jit(ref_sharding.full_step)(*inputs))
    d = np.abs(rgb.numpy().astype(np.int64) - want_rgb)
    assert d.max() <= 1 and (d > 0).sum() <= d.size * 1e-4
    d = np.abs(requant.numpy().astype(np.int64) - want_requant)
    assert d.max() <= 1 and (d > 0).sum() <= d.size * 1e-4
    if not d.any():
        assert np.array_equal(hists.numpy(), want_hists)


def test_chip_smoke_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s K6 phase end to end on the CPU at small shapes of
    both samplings, the timers stubbed: the wrapper takes the plain
    version, and every check holds; the two records (4:2:0, then 4:2:2)
    carry the launches they are handed and their bounds at 12 and 14 B a
    luma pixel."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    failed = []
    monkeypatch.setattr(smoke, "check", lambda ok, what: ok or failed.append(what))
    monkeypatch.setattr(smoke, "K6_SHAPES", ((2, 4, 8, 2), (1, 2, 66, 2), (2, 3, 8, 1),
                                             (1, 5, 66, 1)))
    monkeypatch.setattr(smoke, "FLUSH_BYTES", 64)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(smoke, "device_ms", lambda *fns, **kw: [0.5 for fn in fns
                                                                 if fn() is not None])
    records = smoke.phase_color_round_trip(torch.device("cpu"), (1, 2))
    assert failed == []
    assert [(r["name"], r["launches"]) for r in records] == [
        ("color_round_trip[full_step]", 1), ("color_round_trip[full_step 4:2:2]", 2)]
    for record in records:
        assert record["max_abs_err"] == 0 and record["bound_by"] == "bytes"
        assert record["ms"] == record["plain_ms"] == 0.5
    assert [r["launches"] for r in smoke.phase_color_round_trip(torch.device("cpu"))] == [
        None, None]
    assert records[0]["bound_ms"] == pytest.approx(12 * 2 * 4 * 8 * 64 / 3.35e12 * 1e3)
    assert records[1]["bound_ms"] == pytest.approx(14 * 2 * 3 * 8 * 64 / 3.35e12 * 1e3)
