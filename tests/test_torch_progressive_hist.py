"""PyTorch port, K7: the per-image symbol statistics of a progressive scan
script (``kernels.progressive_histograms``, its plain version
``encode_stage.progressive_histograms_plain`` and ``parallel.sharding.
progressive_step``), held on the CPU to the plain reference
``tests/reference_progressive.py`` and to the host emitter's count
(``native/scanner.cpp`` ``jpx_encode_prog_*``), and the transcoder's
device route, byte for byte the host route's."""

import numpy as np
import pytest
import torch

import reference_progressive as ref
from jpeglibrary_tpu_torch.host.models import progressive_encoder
from jpeglibrary_tpu_torch.host.models.progressive_encoder import SCRIPT_1, SCRIPT_3
from jpeglibrary_tpu_torch.host.native import scanner as native
from jpeglibrary_tpu_torch.host.ops import encode_stage as host_encode_stage
from jpeglibrary_tpu_torch.ops import encode_stage, kernels
from jpeglibrary_tpu_torch.parallel.sharding import progressive_step

CPU = torch.device("cpu")
# Other bands and point transforms, every bit refined.
SCRIPT_WIDE = [
    ((0, 1, 2), 0, 0, 0, 0),
    ((0,), 1, 2, 0, 3), ((0,), 3, 63, 0, 2), ((0,), 1, 2, 3, 2),
    ((0,), 1, 63, 2, 1), ((0,), 1, 63, 1, 0),
    ((1,), 1, 63, 0, 0), ((2,), 1, 20, 0, 1), ((2,), 21, 63, 0, 0), ((2,), 1, 20, 1, 0),
]


def _padded(size):
    return 2 * -(-size[0] // 16), 2 * -(-size[1] // 16)


def _planes(seed, b, size, density, scale=12.0):
    """4:2:0 int16 planes of images of ``size``: a fraction ``density`` of
    the AC coefficients non-zero, magnitudes falling with the position,
    both signs."""
    g = torch.Generator().manual_seed(seed)
    hb, wb = _padded(size)
    out = []
    for shape in ((b, hb, wb, 64), (b, hb // 2, wb // 2, 64), (b, hb // 2, wb // 2, 64)):
        x = torch.randn(shape, generator=g) * torch.exp(-torch.arange(64) / 16.0) * scale
        keep = torch.rand(shape, generator=g) < density
        keep[..., 0] = True
        out.append((x * keep).round().to(torch.int16))
    return out


def _native_rows(planes, size, script):
    """One image's rows as the host emitter counts them (count mode of
    ``jpx_encode_prog_dc`` / ``_ac_first`` / ``_ac_refine``)."""
    sampling = ref.SAMPLING_420[:len(planes)] if len(planes) == 3 else ((1, 1),)
    coeffs = [p.numpy() for p in planes]
    mcu = [host_encode_stage.mcu_order_blocks(c, s[0], s[1]) for c, s in zip(coeffs, sampling)]
    grid = [np.ascontiguousarray(c[:r, :k]).reshape(-1, 64) for c, (r, k) in zip(
        coeffs, (encode_stage.progressive_grid(size, sampling, i) for i in range(len(coeffs))))]
    rows = []
    for comps, ss, se, ah, al in script:
        if ss == 0:
            if ah == 0:
                per = [sampling[i][0] * sampling[i][1] for i in comps]
                freqs = [np.zeros(256, np.int64) for _ in comps]
                native.encode_prog_dc([mcu[i] for i in comps], per, mcu[comps[0]].shape[0] // per[0],
                                      ah, al, freqs=freqs)
                rows.extend(freqs)
            continue
        freq = np.zeros(256, np.int64)
        count = native.encode_prog_ac_first if ah == 0 else native.encode_prog_ac_refine
        count(grid[comps[0]], ss, se, al, freq=freq)
        rows.append(freq)
    return torch.from_numpy(np.stack(rows))


def _check(planes, size, script=SCRIPT_3, native_too=True):
    want = ref.histograms(planes, size, script)
    got = encode_stage.progressive_histograms_plain(*planes, script, size=size)
    assert got.dtype == torch.int32 and tuple(got.shape) == tuple(want.shape)
    assert ref.bins_off(got, want) == 0
    assert ref.bins_off(kernels.progressive_histograms(*planes, script, size=size), want) == 0
    if native_too:
        for b in range(planes[0].shape[0]):
            assert ref.bins_off(_native_rows([p[b] for p in planes], size, script), want[b]) == 0
    return got


@pytest.mark.parametrize("size,density", [((29, 37), 0.5), ((37, 29), 0.9), ((375, 500), 0.3),
                                          ((16, 16), 0.0), ((64, 200), 0.05)])
def test_plain_version_equals_reference_and_emitter_on_ragged_grids(size, density):
    """Luma grids smaller than their padded planes (37 x 29: 4 x 5 of 4 x 6;
    500 x 375: 47 x 63 of 48 x 64), and whole ones."""
    _check(_planes(sum(size), 2, size, density), size)


def test_flat_luma_runs_past_0x7fff():
    """A flat luma of 32,768 blocks and more: runs split into 0xE0s."""
    size = (16, 8 * 16400)
    planes = _planes(5, 1, size, 0.0)
    got = _check(planes, size, native_too=True)
    luma_ac = [r for r, (_, c) in enumerate(ref.rows(SCRIPT_3)) if c == 0][1:]
    assert all(int(got[0, r, 0xE0]) >= 1 for r in luma_ac)
    assert ref.bins_off(ref.histograms(planes, size, fault="runs_not_split"),
                        ref.histograms(planes, size)) > 0


@pytest.mark.parametrize("al", [1, 2])
def test_negative_coefficients_and_a_block_non_zero_at_se(al):
    """Negative values under a magnitude point transform (|v| >> Al, not
    v >> Al), and blocks whose last coefficient of the band is non-zero
    (they code no EOB)."""
    size = (48, 96)
    planes = _planes(al, 2, size, 0.4)
    for p in planes:
        p[..., 1:] = -p[..., 1:].abs()
        p[:, ::2, :, 63] = -(2 ** (al + 1)) - 1
        p[:, :, ::3, 5] = -3
    script = [((0, 1, 2), 0, 0, 0, al), ((0,), 1, 5, 0, al), ((0,), 6, 63, 0, al),
              ((1,), 1, 63, 0, al), ((2,), 1, 63, 0, al)]
    script += [((0, 1, 2), 0, 0, a + 1, a) for a in range(al - 1, -1, -1)]
    script += [((c,), 1, 63, a + 1, a) for a in range(al - 1, -1, -1) for c in range(3)]
    _check(planes, size, script)
    assert ref.bins_off(ref.histograms(planes, size, script, fault="arithmetic_shift"),
                        ref.histograms(planes, size, script)) > 0


def test_refinement_runs_skip_corrections():
    """Refinement blocks with 16 and more zeros between newly significant
    coefficients and correction bits among them: only t == 0 counts."""
    size = (32, 64)
    planes = _planes(9, 2, size, 0.0)
    for p in planes:
        p[..., 1] = 1
        p[..., 3] = 6      # a correction bit at Al = 0 and 1
        p[..., 25] = -1    # 22 positions after 3, 21 of them zero
        p[..., 30] = 9
        p[..., 50] = 1     # 24 positions after 25, 23 zero, one a correction
        p[:, ::2, :, 63] = 1
    got = _check(planes, size)
    assert int(got[:, :, 0xF0].sum()) > 0
    assert ref.bins_off(ref.histograms(planes, size, fault="corrections_as_zeros"),
                        ref.histograms(planes, size)) > 0


def test_other_script_and_one_component():
    size = (61, 77)
    planes = _planes(13, 2, size, 0.7, scale=40.0)
    _check(planes, size, SCRIPT_WIDE)
    gray = (planes[0][:, :8, :10].contiguous(),)
    want = ref.histograms(gray, (64, 80), SCRIPT_1, ((1, 1),))
    got = kernels.progressive_histograms(gray[0], None, None, SCRIPT_1)
    assert ref.bins_off(got, want) == 0
    assert ref.bins_off(_native_rows([gray[0][0]], (64, 80), SCRIPT_1), want[0]) == 0


@pytest.mark.parametrize("script,message", [
    ([((0,), 1, 63, 0, 1), ((0,), 2, 9, 0, 0)], "two symbols"),
    ([((0,), 1, 63, 0, 1), ((0,), 1, 63, 3, 1)], "Ah 3"),
    ([((0,), 1, 63, 0, 1)] + [((0,), 1, 63, 1, 0)] * 2, "two symbols"),
    ([((0, 1), 1, 63, 0, 0)], "one component"),
    ([((0,), 0, 5, 0, 0)], "mixes DC and AC"),
    ([((0,), 0, 0, 0, 0), ((0,), 0, 0, 0, 1)], "two DC first"),
    ([((0,), 1, 63, 1, 0)] + [((0,), k, k, 0, 1) for k in range(1, 9)], "more than 8"),
])
def test_plan_refuses_scripts_it_cannot_count(script, message):
    with pytest.raises(ValueError, match=message):
        encode_stage.progressive_plan(script, 3)


def test_plan_rows_follow_the_script():
    n, plans = encode_stage.progressive_plan(SCRIPT_3, 3)
    assert n == 11 == len(ref.rows(SCRIPT_3))
    assert [p.dc for p in plans] == [(1, 0), (1, 1), (1, 2)]
    assert [[s[4] for s in p.ac] for p in plans] == [[3, 6, 7, 10], [4, 8], [5, 9]]


def test_wrapper_refuses_planes_of_another_size():
    planes = _planes(1, 1, (32, 32), 0.5)
    with pytest.raises(ValueError, match="MCU padding"):
        kernels.progressive_histograms(*planes, SCRIPT_3, size=(64, 32))
    with pytest.raises(TypeError, match="int16"):
        kernels.progressive_histograms(planes[0].int(), *planes[1:], SCRIPT_3)
    with pytest.raises(ValueError, match="no K7 kernel"):
        kernels.progressive_histograms(*(p.to("meta") for p in planes), SCRIPT_3)


def test_step_is_the_plain_version_on_the_cpu():
    size = (90, 130)
    planes = _planes(21, 3, size, 0.5)
    got = progressive_step(*(p.numpy() for p in planes), size=size, device=CPU)
    assert got.device == CPU and tuple(got.shape) == (3, 11, 256)
    assert ref.bins_off(got, ref.histograms(planes, size)) == 0


class _Recorder(progressive_encoder.HuffmanTableBuilder):
    seen = []

    def add_frequencies(self, freq):
        type(self).seen.append(np.asarray(freq, dtype=np.int64).copy())
        return super().add_frequencies(freq)


def _pass_one(monkeypatch, fn):
    _Recorder.seen = []
    monkeypatch.setattr(progressive_encoder, "HuffmanTableBuilder", _Recorder)
    out = fn()
    return out, list(_Recorder.seen)


@pytest.mark.parametrize("size", [(37, 29), (120, 200)])
def test_encode_progressive_pass_one_on_the_device_equals_the_host_count(monkeypatch, size):
    """The per-class sums of the step's rows are the native pass 1's
    frequencies, table for table, and the bytes are the host route's."""
    planes = [p[0].numpy() for p in _planes(size[0], 1, size, 0.45)]
    from jpeglibrary_tpu_torch.host.syntax.quantization import (
        scale_by_quality, standard_chrominance_table, standard_luminance_table)

    quants = [scale_by_quality(standard_luminance_table(0), 90),
              scale_by_quality(standard_chrominance_table(1), 90)]

    def encode(device):
        return progressive_encoder.encode_progressive(
            None, quants, ref.SAMPLING_420, quant_ids=[0, 1, 1], table_ids=[0, 1, 1],
            script=SCRIPT_3, coefficients=planes, size=size, device=device)

    host, host_freqs = _pass_one(monkeypatch, lambda: encode(None))
    card, card_freqs = _pass_one(monkeypatch, lambda: encode(CPU))
    assert len(host_freqs) == len(card_freqs) == 4
    for a, b in zip(host_freqs, card_freqs):
        np.testing.assert_array_equal(a, b)
    assert host == card
    with pytest.raises(ValueError, match="restart"):
        progressive_encoder.encode_progressive(
            None, quants, ref.SAMPLING_420, quant_ids=[0, 1, 1], table_ids=[0, 1, 1],
            script=SCRIPT_3, coefficients=planes, size=size, device=CPU, restart_interval=4)


@pytest.mark.parametrize("shape,sampling", [((61, 75), "420"), ((64, 48), "444")])
def test_transcode_progressive_with_a_device_writes_the_same_bytes(shape, sampling):
    import jpeglibrary_tpu_torch as jtt

    rgb = (np.random.default_rng(shape[0]).random((*shape, 3)) * 255).astype(np.uint8)
    data = progressive_encoder.encode_progressive_rgb(rgb, 85, subsampling=sampling)
    assert jtt.transcode(data, "progressive", device=CPU) == jtt.transcode(data, "progressive")
    gray = jtt.encode_gray((rgb[..., 0] // 2).copy(), 80, device="cpu")
    assert jtt.transcode(gray, "progressive", device=CPU) == jtt.transcode(gray, "progressive")
    with pytest.raises(ValueError, match="no device count"):
        jtt.transcode(data, "optimized", device=CPU)
