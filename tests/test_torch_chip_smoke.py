"""PyTorch port, the card check's CPU side: the baseline encoder in
chip_smoke.py writes streams that the JAX package's host decoder reads
back to the very coefficients it quantised, with the JAX package's own
quant tables; the port's CPU path (chip_smoke.py's golden) decodes them
within the device contract of the host golden; and without a CUDA
device the script exits non-zero and prints no result."""

import contextlib
import importlib.util
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jpeglibrary_tpu as jt
import jpeglibrary_tpu_torch as jtt

from torch_reference_native import settle

settle()  # the JAX package's native scanner, built once before any test

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _longest_zero_run(planes):
    """The longest run of zero AC coefficients ahead of a non-zero one."""
    longest = 0
    for blk in np.concatenate([p.reshape(-1, 64) for p in planes]):
        positions = np.r_[0, np.flatnonzero(blk[1:]) + 1]
        if len(positions) > 1:
            longest = max(longest, int(np.diff(positions).max()) - 1)
    return longest


# Quality 20 leaves zero runs of 16 and more (ZRL symbols); quality 100
# fills blocks to their last coefficient (no EOB) with 11-bit DC steps.
@pytest.mark.parametrize("quality", [20, 75, 100])
def test_encoder_round_trips_through_host_decoder(smoke, quality):
    rgb = smoke.synth_image(quality, 112)
    planes, quants = smoke.quantised_planes(rgb, quality)
    if quality == 20:
        assert _longest_zero_run(planes) >= 16
    if quality == 100:
        assert (planes[0][..., 63] != 0).any()
    res = jt.decode(smoke.encode_420(rgb, quality), sparse_direct=True)
    assert res.packed_mcu2 is not None
    comps = res.geometry.components
    assert [(c.h, c.v) for c in comps] == [(2, 2), (1, 1), (1, 1)]
    for c, plane in zip(comps, planes):
        np.testing.assert_array_equal(res.coefficients[c.component_index], plane)
    ref = jt.decode(jt.encode_rgb(rgb, quality, subsampling="420"))
    for c, quant in zip(comps, (quants[0], quants[1], quants[1])):
        np.testing.assert_array_equal(res.quant[c.component_index], quant[smoke.ZIGZAG])
        np.testing.assert_array_equal(res.quant[c.component_index],
                                      ref.quant[c.component_index])


def test_cpu_golden_matches_host_decode(smoke):
    rgb = smoke.synth_image(3, 256)
    res = jtt.decode(smoke.encode_420(rgb, 75), sparse_direct=True)
    got = jtt.to_rgb8_device(res, device="cpu").numpy()
    want = np.moveaxis(res.to_rgb8(), -1, 0)
    d = np.abs(got.astype(np.int64) - want)
    assert d.max() <= 2 and (d > 0).sum() <= d.size * 1e-4, (d.max(), (d > 0).sum())
    assert smoke.psnr(got, np.moveaxis(rgb, -1, 0)) >= smoke.MIN_PSNR_DB


def test_encoder_streams_take_v1_wire_when_pinned(smoke, monkeypatch):
    """chip_smoke.py's wire phase pins the v1 MCU wire with ``JPX_WIRE=1``:
    its streams then carry a v1 MCU payload, which the port's CPU path
    decodes to the v2 wire's very image."""
    data = smoke.encode_420(smoke.synth_image(4, 128), 75)
    v2 = jtt.to_rgb8_device(jtt.decode(data, sparse_direct=True), device="cpu")
    monkeypatch.setenv("JPX_WIRE", "1")
    res = jtt.decode(data, sparse_direct=True)
    assert res.packed_mcu is not None and res.packed_mcu2 is None
    assert torch.equal(jtt.to_rgb8_device(res, device="cpu"), v2)
    outs = list(jtt.decode_stream_rgb([data, data], device="cpu", group=2))
    assert all(torch.equal(o, v2) for o in outs)


def test_arithmetic_encode_lands_on_delta_wire(smoke):
    """chip_smoke.py's arithmetic streams come from the port's own encode;
    the fused scan declines them, so after the scan worker's ``prepack``
    they ride the v1 plane-order wire, within the contract of the host
    decode."""
    from jpeglibrary_tpu_torch.parallel.batch import scan

    rgb = smoke.synth_image(5, 128)
    data = jtt.encode_rgb(rgb, 75, arithmetic=True, device="cpu")
    res = scan(data)
    assert res.packed_mcu2 is None and res.packed_mcu is None
    assert getattr(res, "_packed", None) is not None
    got = jtt.to_rgb8_device(res, device="cpu").numpy()
    want = np.moveaxis(jt.decode(data).to_rgb8(), -1, 0)
    d = np.abs(got.astype(np.int64) - want)
    assert d.max() <= 2 and (d > 0).sum() <= d.size * 1e-4, (d.max(), (d > 0).sum())
    assert smoke.psnr(got, np.moveaxis(rgb, -1, 0)) >= smoke.MIN_PSNR_DB


def test_exits_nonzero_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout


# The bounds chip_smoke.py reports beside each kernel time: the larger of
# the bytes at 3.35 TB/s and the product at 989 TFLOP/s (bf16, dense) plus
# the per-element operations at 67 TFLOP/s (an H100 SXM's published
# rates), at the main paths' shapes.
@pytest.mark.parametrize("kernel,args,want_us,by", [
    ("k1", (65536, 1, 8, 4), 10.02, "bytes"),      # one 4.2 MP Y plane, int32
    ("k1", (16384, 1, 8, 4), 2.51, "bytes"),       # one chroma plane
    ("k1", (65536, 1, 8, 2), 7.52, "bytes"),       # int16 coefficients
    ("k1", (8 * 65536, 8, 8, 4), 80.14, "bytes"),  # a group of 8 Y planes
    ("k1", (65536, 1, 4, 4), 6.26, "bytes"),       # thumbnails at 1/2, 1/4, 1/8
    ("k1", (65536, 1, 2, 4), 5.32, "bytes"),
    ("k1", (65536, 1, 1, 4), 5.09, "bytes"),
    ("k2", (65536, 4), 7.52, "bytes"),             # 12-bit int32 samples
    ("k2", (65536, 1), 3.76, "bytes"),             # the Y plane, uint8
    ("k2", (16384, 1, 2048 * 2048), 1.88, "bytes"),  # a 2048x2048 chroma plane at 2x2
    ("k2", (256 * 86, 1, 2048 * 2048), 2.10, "bytes"),  # at 3x1
    ("k2", (64 * 64, 4, 2048 * 2048), 5.17, "bytes"),   # int32 at 4x4
])
def test_kernel_bounds(smoke, kernel, args, want_us, by):
    ms, bound_by = (smoke.k1_bound if kernel == "k1" else smoke.k2_bound)(*args)
    assert bound_by == by
    assert abs(ms * 1e3 - want_us) < 0.01, ms * 1e3


@pytest.fixture(scope="module")
def k2_probe():
    spec = importlib.util.spec_from_file_location("k2_probe", ROOT / "tools" / "k2_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("variant", ["whole kernel", "no MMAs", "multiply for divide",
                                     "no product or epilogue", "copies and stores only",
                                     "timeline"])
def test_k2_probe_cuts_apply_to_the_kernel_source(k2_probe, variant):
    """tools/k2_probe.py times K2 with parts cut out by text substitutions
    on csrc/fdct_quant.cu: each must still find its text exactly once."""
    subs = k2_probe.TIMELINE if variant == "timeline" else k2_probe.CUT[variant]
    text = k2_probe.variant_source(subs)
    assert "fdct_quant_kernel" in text
    assert all(new in text for _, new in subs)


def test_k2_probe_exits_nonzero_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "k2_probe.py")], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "parts:" not in r.stdout


@pytest.fixture(scope="module")
def k5_probe():
    spec = importlib.util.spec_from_file_location("k5_probe", ROOT / "tools" / "k5_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("variant", ["whole kernel", "staged loads only", "loads and masks",
                                     "no AC atomics", "walk and atomics, no symbols", "2 stages",
                                     "4 stages", "clock", "conflict-free gather",
                                     "conflict-free gather, no AC atomics"])
def test_k5_probe_cuts_apply_to_the_kernel_source(k5_probe, variant):
    """tools/k5_probe.py times K5 with parts cut out by text substitutions
    on csrc/symbol_hist.cu: each must still find its text exactly once."""
    subs = k5_probe.CYCLES if variant == "clock" else k5_probe.CUT[variant]
    text = k5_probe.variant_source(subs)
    assert "symbol_hist_kernel" in text
    assert all(new in text for _, new in subs)
    assert set(k5_probe.EXACT) <= set(k5_probe.CUT)


def test_k5_probe_exits_nonzero_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "k5_probe.py")], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "parts:" not in r.stdout


@pytest.fixture(scope="module")
def k1_probe():
    spec = importlib.util.spec_from_file_location("k1_probe", ROOT / "tools" / "k1_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_k1_probe_launches_are_the_cells_steps(k1_probe):
    """tools/k1_probe.py times K1's launches of each benchmark cell's step:
    the luma and twice the chroma of a 4:2:0 batch (half size, planes padded
    to whole 16 x 16 MCUs) or of a 4:2:2 batch (half width, whole 16 x 8
    MCUs), the plane store on a one-component series; a cell of the
    progressive transcode's count pass runs no K1."""
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in bench["configs"]}
    want = set()
    for cell in bench["workloads"]:
        config = configs[cell["config"]]
        traffic = json.loads((ROOT / "jpegbench" / "traffic" / f"{cell['traffic']}.json").read_text())
        if traffic["entry"] == "transcode_progressive":
            continue
        b = traffic["batch"]
        if config.get("components") == 1:
            want.add((cell["name"], 1, "plane", (b, config["height"] // 8, config["width"] // 8)))
            continue
        vs = 1 if config.get("subsampling") == "4:2:2" else 2
        hb, wb = -(-config["height"] // (8 * vs)) * vs, -(-config["width"] // 16) * 2
        want.add((cell["name"], 1, "blocks", (b, hb, wb)))
        want.add((cell["name"], 2, "blocks", (b, hb // vs, wb // 2)))
    got = {(cell, per_step, store, shape)
           for cell, _, per_step, store, shape, _, _ in k1_probe.LAUNCHES}
    assert got == want


def test_k1_probe_shares(k1_probe):
    """A K1 launch at the FFMA floor reads 100% of it, and the bytes bound
    counts 2 B in and 4 (or 2) B out a sample."""
    probe = k1_probe
    n = 1 << 20
    floor_ms = n * 8192 / 67e12 * 1e3
    by_bytes, by_ffma, ns = probe.shares(n, 4, floor_ms)
    assert abs(by_ffma - 1) < 1e-12 and abs(ns - 8192 / 67e12 * 1e9) < 1e-9
    assert abs(by_bytes - n * 64 * 6 / 3.35e12 * 1e3 / floor_ms) < 1e-12
    assert probe.shares(n, 2, floor_ms)[0] == pytest.approx(by_bytes * 4 / 6)


def test_k1_probe_exits_nonzero_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "k1_probe.py")], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "time:" not in r.stdout


@pytest.mark.parametrize("hs,vs", [(3, 1), (1, 3), (3, 3), (4, 3), (4, 4)])
@pytest.mark.parametrize("precision", [8, 12])
def test_box_encoder_matches_jax_device_encode(smoke, hs, vs, precision):
    """chip_smoke.py's box phase encodes with box_encoder: on the CPU it
    gives the JAX device encode's bytes, and its second component takes
    the (hs, vs) box."""
    import jax.numpy as jnp

    from jpeglibrary_tpu.models.encoder import JpegEncoder as RefEncoder
    from jpeglibrary_tpu.syntax.quantization import scale_by_quality, standard_luminance_table

    rgb = smoke.synth_image(hs * 10 + vs, 96)
    planes = [rgb[..., 0], rgb[..., 1]]
    if precision == 12:
        planes = [p.astype(np.int32) * 16 for p in planes]
    ours = jtt.encode(smoke.box_encoder(planes, hs, vs, precision), device="cpu")
    ref = RefEncoder()
    ref.sample_precision = precision
    ref.set_quantization_table(scale_by_quality(standard_luminance_table(0), 75))
    ref.set_huffman_table(True, 0)
    ref.set_huffman_table(False, 0)
    ref.add_component(1, 0, 0, 0, hs, vs)
    ref.add_component(2, 0, 0, 0, 1, 1)
    ref.set_input(planes)
    assert ours == ref.encode(xp=jnp)
    res = jt.decode(ours)
    comps = res.geometry.components
    assert [(c.hs, c.vs) for c in comps] == [(1, 1), (hs, vs)]


def test_u16_check_counts_a_wrapped_sample_as_one(smoke):
    """check_u16_close compares samples: 4095 against 0 at 12 bits is a
    sample 1 below 0 that the writer wrapped, one LSB; 4094 against 0 is
    not."""
    want = np.zeros((100, 100, 1), np.uint16)
    got = want.copy()
    got[0, 0, 0] = 4095 << 4 | 0xF
    smoke.check_u16_close(got, want, 12, "wrap")
    got[0, 0, 0] = 4094 << 4
    with pytest.raises(SystemExit):
        smoke.check_u16_close(got, want, 12, "no wrap")


@pytest.mark.parametrize("ri", [0, 2, 5, 1000])
def test_segment_rows_are_the_device_scans_rows(smoke, ri):
    """chip_smoke.py holds K3 to the host scan through
    device_scan.segment_rows: the host decode's planes laid out as the
    device scan's rows equal the JAX device scan's output and the port's
    plain version, tail segment and an interval longer than the image
    included."""
    from jpeglibrary_tpu.ops import device_scan as ref_scan

    from jpeglibrary_tpu_torch.ops import device_scan

    data = jtt.encode_rgb(smoke.synth_image(ri, 80), 75, device="cpu", restart_interval=ri)
    res = jtt.decode(data, sparse_direct=True)
    geo = res.geometry
    rows = device_scan.segment_rows(
        [res.coefficients[c.component_index] for c in geo.components], geo, ri)
    np.testing.assert_array_equal(rows, np.asarray(ref_scan.decode_baseline_device(data)[0]))
    got, _ = device_scan.decode_baseline_device(data, device="cpu")
    np.testing.assert_array_equal(rows, got.numpy())


def test_segment_symbols_count_the_host_gathers_symbols(smoke):
    """The symbols chip_smoke.py counts per segment (for ns per symbol and
    K3's bound) are those the host gather's histograms count in the
    segment's blocks: one DC symbol a block, and the AC symbols, ZRLs and
    EOBs."""
    from jpeglibrary_tpu.ops import encode_stage as ref_encode_stage
    from jpeglibrary_tpu_torch.ops import device_scan

    data = jtt.encode_rgb(smoke.synth_image(20, 96), 20, device="cpu", restart_interval=3)
    coeffs, geo = device_scan.decode_baseline_device(data, device="cpu")
    _, const, _ = device_scan.scan_inputs(data)
    n_blocks = torch.from_numpy(const["mcu_counts"]).long() * const["bpm"]
    got = smoke.segment_symbols(coeffs, n_blocks)
    want = []
    for row, n in zip(coeffs.numpy(), n_blocks.tolist()):
        dc, ac = ref_encode_stage.dc_ac_symbol_frequencies(row.reshape(-1, 64)[:n])
        want.append(int(dc.sum() + ac.sum()))
    assert got.tolist() == want
    assert sum(want) > 2 * n_blocks.sum()  # AC symbols and EOBs besides the DC ones


@pytest.mark.parametrize("buf_bytes,out_bytes,symbols,want_us", [
    (895_616, 25_165_824, 1_452_281, 7.7835),   # a 2048x2048 image at ri 128
    (1_019_904, 25_165_824, 1_452_281, 7.8206),  # at ri 4
])
def test_k3_bound(smoke, buf_bytes, out_bytes, symbols, want_us):
    """The segments and six tables in, the output written once."""
    ms, by = smoke.k3_bound(buf_bytes, out_bytes, 6, symbols)
    assert by == "bytes"
    assert abs(ms * 1e3 - want_us) < 1e-3, ms * 1e3


def test_new_phases_rehearse_on_the_cpu(smoke, monkeypatch):
    """The device-scan and full-step phases run end to end on the CPU at a
    small size with the timers stubbed: every check holds but the launch
    counts (K2's by walk among them) and K5's in-place walk, which only the
    card can meet (the CPU takes the plain versions, and K5's copies the
    step's planes into walk order: three 6-D permutes and the chroma cat)."""
    failed = []
    monkeypatch.setattr(smoke, "check", lambda ok, what: ok or failed.append(what))
    monkeypatch.setattr(smoke, "SIZE", 32)
    monkeypatch.setattr(smoke, "FLUSH_BYTES", 64)
    monkeypatch.setattr(smoke, "RESTART_INTERVALS", (2, 1))
    monkeypatch.setattr(smoke, "PLAIN_RIS", (2, 1))
    monkeypatch.setattr(smoke, "CORRUPT_BYTES", 100)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    no_trace = types.SimpleNamespace(key_averages=lambda: [])  # CPU torch traces no CUDA
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: contextlib.nullcontext(no_trace))
    stub = lambda *fns, **kw: [0.5 for fn in fns if fn() is not None]
    monkeypatch.setattr(smoke, "kernel_ms", stub)
    monkeypatch.setattr(smoke, "device_ms", stub)
    monkeypatch.setattr(smoke, "wall_ms", lambda fn, **kw: stub(fn)[0])
    sources = [smoke.synth_image(s, 32) for s in range(2)]
    datas = [smoke.encode_420(rgb, 75) for rgb in sources]
    scan = smoke.phase_device_scan(sources, datas, torch.device("cpu"))
    step, k6_launches = smoke.phase_full_step(smoke.step_inputs(datas), torch.device("cpu"))
    assert set(scan) == {0, 1, 2, "small"}
    assert [r["name"] for r in step.values()] == ["dequantize_idct_shift[full_step]",
                                                  "fdct_quantize[full_step]",
                                                  "symbol_histograms[full_step]"]
    assert step["k5"]["library_ms"] is None and step["k5"]["bound_by"] == "bytes"
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    assert scan[0]["plain_ms"] is None and scan[0]["max_abs_err"] is None  # no plain run
    for rec in [scan[1], scan[2], scan["small"], *step.values()]:
        assert rec["max_abs_err"] == 0 and rec["plain_ms"] > 0
    for rec in [*scan.values(), *step.values()]:
        assert set(rec) == keys and rec["launches"] == 0 and rec["bound_ms"] > 0
        assert (ROOT / rec["source"]).is_file()
    # The CPU model's sync rounds are held to K3's, which the plain version
    # (the wrapper on the CPU) does not count.
    assert failed[:4] == [(2, "K3 launches", 0), (1, "K3 launches", 0), (0, "K3 launches", 0),
                          ("small ri 0: K3 launches", 0)]
    assert [f[0] for f in failed[4:6]] == ["small ri 0: K3 differs from its CPU model",
                                           "small ri 0, corrupt: K3 differs from its CPU model"]
    assert all(f[1] >= 2 and f[2] == 0 for f in failed[4:6])  # (model rounds, K3 rounds)
    assert k6_launches == 0
    assert failed[6] == ("full_step launches", 0, 0, 0, 0)
    assert failed[7] == ("full_step's K2 walks", {})
    assert failed[8][0] == "full_step copies its blocks for the statistics"
    assert [op for op, _ in failed[8][1]] == ["permute"] * 3 + ["cat"]
    assert len(failed) == 9


def test_full_step_422_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """The 4:2:2 full-step phase runs end to end on the CPU at a small size:
    its step agrees with the plain step and its histograms with the host
    gather in (2, 1) MCU order; only the launch counts fail, by sampling
    and by walk, which only the card meets."""
    failed = []
    monkeypatch.setattr(smoke, "check", lambda ok, what: ok or failed.append(what))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    datas = [smoke.encode_420(smoke.synth_image(s, 32), 75) for s in range(2)]
    inputs = smoke.step_inputs(datas)
    (y, cb, cr), _ = smoke.inputs_422(inputs)
    assert cb.shape == cr.shape == (2, 4, 2, 64) and y.shape == (2, 4, 4, 64)
    assert np.array_equal(cb[:, 0::2], inputs[0][1]) and np.array_equal(cb[:, 1::2], cb[:, 0::2])
    assert smoke.phase_full_step_422(inputs, torch.device("cpu")) == 0
    assert failed == [("full_step 4:2:2 launches", 0, 0, 0, 0),
                      ("full_step 4:2:2 K6 boxes", {}), ("full_step 4:2:2 K2 boxes", {}),
                      ("full_step 4:2:2 K2 walks", {})]


def test_gray_step_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """The gray-step phase runs end to end on the CPU at small shapes with
    the timers stubbed: every check holds but the launch counts (K2's by
    walk among them), which only the card meets (the CPU takes the plain
    versions)."""
    failed = []
    monkeypatch.setattr(smoke, "check", lambda ok, what: ok or failed.append(what))
    monkeypatch.setattr(smoke, "GRAY_SHAPES", ((4, 3, 5), (3, 5, 7), (2, 2, 3)))
    monkeypatch.setattr(smoke, "FLUSH_BYTES", 64)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    stub = lambda *fns, **kw: [0.5 for fn in fns if fn() is not None]
    monkeypatch.setattr(smoke, "device_ms", stub)
    records = smoke.phase_gray_step(torch.device("cpu"))
    assert failed == [("gray_step launches", (0, 0, 0)), ("gray_step's K2 walks", {})]
    assert [r["name"] for r in records] == ["dequantize_idct_plane[gray_step]",
                                            "fdct_quantize[gray_step, uint16]",
                                            "symbol_histograms[gray_step]"]
    for rec in records:
        assert rec["ms"] == rec["plain_ms"] == 0.5 and rec["bound_by"] == "bytes"
        assert rec["launches"] == 0
        assert rec["max_abs_err"] == 0  # measured: the CPU's step is the plain step
        assert (ROOT / rec["source"]).is_file()


def test_gray_step_phase_records_what_it_measures(smoke, monkeypatch):
    """Each record of the gray-step phase carries the difference the phase
    measured against the plain step: a step whose samples are off by 2,
    its requantised blocks by 1 and 3 of its histogram bins give 2, 1 and 3."""
    from jpeglibrary_tpu_torch.parallel import sharding

    real = sharding.gray_step

    def skewed(*args, **kwargs):
        samples, requant, hists = (t.clone() for t in real(*args, **kwargs))
        samples.view(torch.int16).view(-1)[0] += 2
        requant.view(-1)[5] += 1
        hists[1, :3] += 1
        return samples, requant, hists

    failed = []
    monkeypatch.setattr(sharding, "gray_step", skewed)
    monkeypatch.setattr(smoke, "check", lambda ok, what: ok or failed.append(what))
    monkeypatch.setattr(smoke, "GRAY_SHAPES", ((2, 2, 3),))
    monkeypatch.setattr(smoke, "FLUSH_BYTES", 64)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    stub = lambda *fns, **kw: [0.5 for fn in fns if fn() is not None]
    monkeypatch.setattr(smoke, "device_ms", stub)
    records = smoke.phase_gray_step(torch.device("cpu"))
    assert [r["max_abs_err"] for r in records] == [2, 1, 3]
    assert ("gray_step", "samples", 1) in failed and ("gray_step histograms", 3) in failed


# The progressive step's rehearsal sizes: a flat luma of 64 x 514 = 32,896
# blocks an image, past 0x7FFF, and a ragged 29 x 37 image.
PROG_SMALL = {"PROG_CELL": (2, 512, 4112), "PROG_RAGGED": (2, 29, 37), "PROG_CHUNK": 1}


def _rehearse_progressive_step(smoke, monkeypatch, failed):
    monkeypatch.setattr(smoke, "check", lambda ok, what: ok or failed.append(what))
    for name, value in PROG_SMALL.items():
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "FLUSH_BYTES", 64)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    stub = lambda *fns, **kw: [0.5 for fn in fns if fn() is not None]
    monkeypatch.setattr(smoke, "device_ms", stub)
    return smoke.phase_progressive_step(torch.device("cpu"))


def test_progressive_step_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """The progressive-step phase runs end to end on the CPU at small
    shapes with the timers stubbed: every check holds but the launch
    counts, which only the card meets (the CPU takes the plain version);
    the flat luma's runs pass 0x7FFF blocks, and K7's record reads the
    bound of one read of the blocks and the histograms' write."""
    failed = []
    rec = _rehearse_progressive_step(smoke, monkeypatch, failed)
    assert failed == [("progressive_step launches", 0, {})]
    assert rec["name"] == "progressive_histograms[progressive_step]"
    assert rec["ms"] == rec["plain_ms"] == rec["library_ms"] == 0.5
    assert rec["launches"] == 0 and rec["max_abs_err"] == 0
    assert (ROOT / rec["source"]).is_file() and rec["bound_by"] == "bytes"
    b, height, width = PROG_SMALL["PROG_CELL"]
    blocks = b * (height // 8) * (width // 8) * 3 // 2
    assert rec["bound_ms"] == pytest.approx((blocks * 128 + b * 11 * 256 * 4) / 3.35e9)


def test_progressive_step_phase_records_what_it_measures(smoke, monkeypatch):
    """A K7 whose histograms are off in 3 bins of each image fails the
    phase's comparisons, and its record carries the bins it measured."""
    from jpeglibrary_tpu_torch.ops import kernels

    real = kernels.progressive_histograms

    def skewed(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[:, 4, :3] += 1
        return out

    skewed.launches, skewed.launches_by_walk = 0, {}
    monkeypatch.setattr(kernels, "progressive_histograms", skewed)
    failed = []
    rec = _rehearse_progressive_step(smoke, monkeypatch, failed)
    b, rb = PROG_SMALL["PROG_CELL"][0], PROG_SMALL["PROG_RAGGED"][0]
    assert rec["max_abs_err"] == 3 * max(b, rb)
    assert ("K7 differs", "cell batch, flat luma", 3 * b) in failed
    assert ("K7 differs", "ragged 2 x 37 x 29", 3 * rb) in failed

PINNED = "Memcpy HtoD (Pinned -> Device)"
PAGEABLE = "Memcpy HtoD (Pageable -> Device)"


def _trace(*events):
    """Chrome-trace device events from (category, name, stream, ts, dur)."""
    return [{"cat": c, "name": n, "args": {"stream": s}, "ts": t, "dur": d}
            for c, n, s, t, d in events]


@pytest.mark.parametrize("events,want", [
    # Two workers' streams 13 and 14 after the spin kernel on the caller's
    # stream 7: the copy on 13 (100-140) lies under 14's kernels over
    # 110-140 once, not under 13's own kernel; the copy on 14 (200-210)
    # starts as 13's kernel ends.
    (_trace(("kernel", "spin_kernel(long)", 7, 0, 50), ("gpu_memcpy", PINNED, 13, 100, 40),
            ("kernel", "k1", 14, 110, 20), ("kernel", "k1", 14, 120, 30),
            ("kernel", "k1", 13, 100, 100), ("gpu_memcpy", PINNED, 14, 200, 10),
            ("gpu_memset", "Memset (Device)", 14, 215, 1)),
     {"caller": 7, "streams": [13, 14], "on_caller": 0, "htod": 2, "pageable": [],
      "copy_us": 50.0, "overlap_us": 30.0, "busy_us": 100.0, "span_us": 116.0}),
    # A pageable copy, and a kernel on the caller's stream, which hides no
    # copy of a worker.
    (_trace(("kernel", "spin_kernel(long)", 7, 0, 5), ("gpu_memcpy", PAGEABLE, 13, 10, 10),
            ("kernel", "k1", 7, 10, 10), ("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 13,
                                          30, 5)),
     {"caller": 7, "streams": [13], "on_caller": 1, "htod": 1, "pageable": [PAGEABLE],
      "copy_us": 10.0, "overlap_us": 0.0}),
    # The first marking spin kernel lost, the one after the path kept.
    (_trace(("gpu_memcpy", PINNED, 13, 0, 10), ("kernel", "k1", 14, 0, 10),
            ("kernel", "at::cuda::(anonymous namespace)::spin_kernel(long)", 7, 30, 50)),
     {"marks": 1, "caller": 7, "streams": [13, 14], "on_caller": 0, "htod": 1,
      "pageable": [], "copy_us": 10.0, "overlap_us": 10.0, "busy_us": 10.0, "span_us": 10.0}),
    # Both marks lost: no caller's stream is known.
    (_trace(("gpu_memcpy", PINNED, 13, 0, 10), ("kernel", "k1", 14, 5, 10)),
     {"marks": 0, "caller": None, "streams": [13, 14], "htod": 1, "overlap_us": 5.0}),
])
def test_overlap_stats_reads_a_trace(smoke, events, want):
    got = smoke.overlap_stats(events)
    assert {k: got[k] for k in want} == want


def test_overlap_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """The overlap phase runs end to end on the CPU at 32 x 32 with a
    synthetic trace: every output and trace check holds but the launch
    counts, which only the card can meet."""
    failed = []
    monkeypatch.setattr(smoke, "check", lambda ok, what: ok or failed.append(what))
    monkeypatch.setattr(smoke, "SIZE", 32)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    traced = []

    def device_trace(fn):
        traced.append(len(fn()))
        return _trace(("kernel", "spin_kernel(long)", 7, 0, 5),
                      ("gpu_memcpy", PINNED, 13, 10, 10), ("kernel", "k1", 14, 5, 10))

    monkeypatch.setattr(smoke, "device_trace", device_trace)
    datas = [smoke.encode_420(smoke.synth_image(s, 32), 75) for s in range(3)]
    cpu = torch.device("cpu")
    rates = smoke.phase_overlap({"datas": datas, "outs": smoke.stream(datas, cpu)}, cpu)
    assert sorted(rates) == [(1, 1), (1, 2), (8, 1), (8, 2)] and all(r > 0 for r in
                                                                      rates.values())
    assert traced == [3] * smoke.OVERLAP_TRACES
    assert failed == [("overlap K1 launches", g, w, 0) for g in (1, 8) for w in (1, 2)]


@pytest.mark.parametrize("n_blocks,itemsize,want_us", [
    (65536, 2, 7.5123),   # the Y plane of a 2048x2048 image, int16 coefficients
    (65536, 4, 10.0163),  # int32 coefficients
    (16384, 2, 1.8781),   # a chroma plane
])
def test_k4_bound(smoke, n_blocks, itemsize, want_us):
    """K4's bound: coefficients and the table in, the int32 plane out, one
    read and one write each; its float work is far below its bytes."""
    ms, by = smoke.k4_bound(n_blocks, itemsize)
    assert by == "bytes"
    assert abs(ms * 1e3 - want_us) < 1e-3, ms * 1e3
    assert smoke.K4_OPS_PER_BLOCK == 1024


@pytest.mark.parametrize("n_blocks,itemsize,n_rows,want_us", [
    (8 * 65536, 2, 0, 20.0331),   # full_step's luma, 8 images of 2048x2048, int16
    (16 * 16384, 2, 0, 10.0169),  # its Cb and Cr chains
    (1024, 4, 1, 0.0789),         # a mesh shard with n_valid and prev_dc, int32
])
def test_k5_bound(smoke, n_blocks, itemsize, n_rows, want_us):
    """K5's bound: the blocks (and n_valid and prev_dc) read once, the two
    histograms written once; one test per coefficient is far below it."""
    ms, by = smoke.k5_bound(n_blocks, itemsize, n_rows)
    assert by == "bytes"
    assert abs(ms * 1e3 - want_us) < 1e-3, ms * 1e3


def test_golden_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """The bit-exact decode phase runs end to end on the CPU at 64 x 64
    with the timers stubbed: every plane, region and K4 check holds, 0
    values differing, but the launch counts, which only the card can meet;
    its record has every key of the kernels line."""
    failed = []
    monkeypatch.setattr(smoke, "check", lambda ok, what: ok or failed.append(what))
    monkeypatch.setattr(smoke, "FLUSH_BYTES", 64)
    monkeypatch.setattr(smoke, "GOLDEN_RECTS", ((3, 5, 20, 17), (1, 31, 63, 1)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    stub = lambda *fns, **kw: [0.5 for fn in fns if fn() is not None]
    monkeypatch.setattr(smoke, "kernel_ms", stub)
    monkeypatch.setattr(smoke, "device_ms", stub)
    lines = []
    monkeypatch.setattr(smoke, "log", lambda *a: lines.append(" ".join(map(str, a))))
    sources = [smoke.synth_image(s, 64) for s in range(2)]
    sl = {"sources": sources, "datas": [smoke.encode_420(rgb, 75) for rgb in sources]}
    rec = smoke.phase_golden(sl, torch.device("cpu"))
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    assert set(rec) == keys and rec["name"] == "butterfly_idct_shift"
    assert rec["max_abs_err"] == 0 and rec["launches"] == 0 and rec["bound_by"] == "bytes"
    assert (ROOT / rec["source"]).is_file() and rec["replaces"].startswith("jpeglibrary_tpu/")
    labels = ["slice image 0", "slice image 1", "12-bit gray", "progressive", "arithmetic",
              "restart 16"]
    assert [f[0] for f in failed] == labels and all(f[1:3] == ("K4 launches", 0) for f in failed)
    planes = [ln for ln in lines if ".planes of" in ln]
    regions = [ln for ln in lines if "decode_region(" in ln]
    k4 = [ln for ln in lines if "K4 vs plain" in ln]
    assert len(planes) == 6 and len(regions) == 10 and len(k4) == 5
    assert all(" 0 values differ" in ln for ln in planes + regions)
    assert all(": 0/" in ln for ln in k4)


@pytest.mark.parametrize("world", [1, 2])
def test_mesh_phase_rehearses_on_cpu_ranks(smoke, world):
    """The mesh phase's ranks (``mesh_rank``) run end to end in gloo CPU
    ranks at 64 x 64: every check holds but the launch counts, which only
    the card can meet."""
    import torch_mesh_workers

    from jpeglibrary_tpu_torch.parallel import distributed

    datas = [smoke.encode_420(smoke.synth_image(s, 64), 75) for s in range(2)]
    ranks = distributed.spawn(torch_mesh_workers.chip_smoke_mesh, world, world, datas, 64,
                              backend="gloo", timeout=120)
    steps = [(1, 1)] if world == 1 else [(2, 1), (2, 2)]
    modes = ["v2"] if world == 1 else ["v2", "v1", "progressive"]
    for r in ranks:
        batch = [("batch mesh K1 launches", (0, 0, 0))] if world == 1 else []
        stats = [("mesh statistics K5 launches", (0, 0, 0))] if world == 1 else []
        assert r["failed"] == ([("sharded step launches", n, s, 0, 0, 0) for n, s in steps]
                               + [("stripe K1 launches", m, 0) for m in modes]
                               + batch + [("global batch K1 launches", (0, 0, 0))] + stats)
        assert all(v == (0, 0, 0) for v in r["launches"].values())
        assert sum("bit for bit" in line for line in r["lines"]) == len(steps) + len(modes) + (
            world == 2) + 1


@pytest.mark.parametrize("recorded,want_ms", [
    # records per window (2 kernels a call, 5 calls) in the order they come
    ([10, 10, 10, 10, 10], 1.0),
    ([10, 0, 4, 10, 10, 10, 10], 1.0),  # windows the profiler cut short are timed again
    ([0, 0, 0, 0, 0, 10, 0, 10, 10, 10, 10], 1.0),
])
def test_kernel_ms_times_only_full_windows(smoke, monkeypatch, recorded, want_ms):
    """kernel_ms holds each window to the most records any of its windows
    held and times short ones again: a window that lost records (CUPTI
    drops some on the card) does not pull the mean down."""
    feed = iter(recorded)
    calls = []

    def profile(**kw):
        n = next(feed)
        rows = [types.SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA, key="k2",
                                      count=n, self_device_time_total=n * 500.0),
                types.SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA,
                                      key="Memset (Device)", count=5,
                                      self_device_time_total=1e6)]
        return contextlib.nullcontext(types.SimpleNamespace(key_averages=lambda: rows))

    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    (ms,) = smoke.kernel_ms(lambda: calls.append(1), runs=25, rounds=5)
    assert ms == pytest.approx(want_ms)
    assert len(calls) == 1 + 5 * len(recorded)  # the warm-up call, then 5 a window
    assert next(feed, None) is None


def test_kernel_ms_raises_when_nothing_is_recorded(smoke, monkeypatch):
    empty = types.SimpleNamespace(key_averages=lambda: [])
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: contextlib.nullcontext(empty))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="no kernel"):
        smoke.kernel_ms(lambda: None, runs=10, rounds=5, retries=3)
