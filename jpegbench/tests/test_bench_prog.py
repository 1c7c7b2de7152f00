"""The ``transcode_progressive`` entry and its cell ``transcode_prog_12mp_b32``
on the CPU: ``spec.load`` finds every file of the cell, at the shapes and
bytes the configuration states; a whole run of a tiny cell of the entry
(set-up, window, check); the reference copy equal to the tests' plain
reference; each fault planted in the reference, put in the program's
place, failing ``hist_bins_off`` at a small size, and the int16 control
failing it too; the calibration's readings on both sides; the six readers on made-up Chrome trace events, their
bounds counted by hand, and None in a run of another entry."""

import json
import pathlib
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT
from jpegbench.core import harness, spec
from jpegbench.core.harness import Context
from jpegbench.core.trace import STEP, WINDOW, Trace
from jpegbench.entries import transcode_progressive as entry
from jpegbench.entries.recompress import Window
from jpegbench.generators import coefficients, content
from jpegbench.reference import tables
from jpegbench.reference import transcode_progressive as ref

CELL = "transcode_prog_12mp_b32"
TINY = "tiny_prog_b3"
SHAPE = {"batch": 32, "width": 4032, "height": 3024, "hb": 378, "wb": 504}
SMALL = {"batch": 1, "width": 16, "height": 16, "hb": 2, "wb": 2}
TRACED = ("k7_roofline.prog", "launches_per_step.prog", "step_host_ms.prog")
HOST = ("step_roofline.prog", "device_idle_pct.prog", "dispatch_ms.prog")
METRICS = TRACED + HOST
SEED = 2**31 + 2626  # larger than 32 signed bits hold, as a benchmark run's seeds may be
LIMITS = json.loads((ROOT / f"jpegbench/limits/{CELL}.json").read_text())


def _checkout(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout with the benchmark's files and a cell ``tiny_prog_b3`` of
    the entry: the phone configuration at 100 x 52 (padded to 112 x 64), 3
    images a step, a pool of 2, the cell's limits; the new metrics list it."""
    shutil.copytree(ROOT / "jpegbench", tmp / "jpegbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "jpegbench/configs/phone_12mp_420_q90_prog.json").read_text())
    config.update(width=100, height=52)
    (tmp / "jpegbench/configs/tiny_prog.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "tiny_prog", "source": "test",
                             "file": "jpegbench/configs/tiny_prog.json", "reduced": [],
                             "why": "a CPU test's size"})
    bench["workloads"].append({"name": TINY, "config": "tiny_prog", "traffic": "prog_b3",
                               "chips": 1, "why": "a CPU test's size"})
    (tmp / "jpegbench/traffic/prog_b3.json").write_text(json.dumps(
        {"entry": "transcode_progressive", "batch": 3, "pool": 2, "in_flight": 2}))
    shutil.copy(ROOT / f"jpegbench/limits/{CELL}.json", tmp / f"jpegbench/limits/{TINY}.json")
    for m in bench["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append(TINY)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def test_spec_finds_every_file_of_the_cell_at_its_shapes():
    from jpegbench.entries.recompress import shape

    w = spec.load(CELL)
    assert w.chips == 1 and w.traffic["entry"] == "transcode_progressive"
    assert w.entry().Run is entry.Run and shape(w.config, w.traffic) == SHAPE
    assert w.config["name"] == "phone_12mp_420_q90_prog" and w.config["reduced"] == []
    assert w.config["subsampling"] == "4:2:0" and w.config["quality"] == 90
    assert w.config["restart_interval"] == 0 and w.config["content"] == "photo"
    assert (w.traffic["batch"], w.traffic["pool"], w.traffic["in_flight"]) == (32, 2, 8)
    assert w.limits == LIMITS == {"hist_bins_off": 0}
    assert {m["name"] for m in w.end_to_end} == {"recompress_mp_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in w.per_layer} == set(METRICS)
    # 390.2 source MP, 9.14 M blocks and 1.171 GB of int16 coefficients a
    # batch; a pool of 2 batches is 2.34 GB.
    b, hb, wb = SHAPE["batch"], SHAPE["hb"], SHAPE["wb"]
    assert b * SHAPE["width"] * SHAPE["height"] == 390_168_576
    blocks = b * hb * wb + 2 * b * (hb // 2) * (wb // 2)
    assert blocks == 9_144_576 and blocks * 128 == 1_170_505_728
    assert coefficients.padded(4032) // 8 == 504 and coefficients.padded(3024) // 8 == 378


def test_reference_copy_equals_the_tests_reference():
    copy = ROOT / "jpegbench/reference/transcode_progressive.py"
    assert copy.read_text() == (ROOT / "tests/reference_progressive.py").read_text()


def _run(root, trace):
    return harness.run(TINY, SEED, 0.3, trace, time.perf_counter(), root=root,
                       device=torch.device("cpu"))


def test_tiny_cell_runs_end_to_end(tmp_path):
    root = _checkout(tmp_path)
    record = _run(root, trace=False)
    assert record["correct"] and record["failed"] == 0 and record["attempted"] > 0
    assert set(record["metrics"]) == {"recompress_mp_s", "setup_s", "peak_mem_gib"}
    assert record["check"] == {"hist_bins_off": {"value": 0.0, "limit": 0}}
    traced = _run(root, trace=True)
    # The CPU launches no kernel: only what the host reads is there.
    assert traced["correct"] and set(traced["metrics"]) == set(HOST)
    assert traced["metrics"]["step_roofline.prog"]["value"] > 0


def _planes(n=3, h=64, w=96, seed=3, quality=90):
    g = torch.Generator().manual_seed(seed)
    qy, qc = (torch.from_numpy(q) for q in tables.quant_tables_zz(quality))
    return coefficients.quantised_planes(content.photo(g, n, h, w), qy, qc)


def test_program_agrees_with_the_reference():
    from jpeglibrary_tpu_torch.parallel.sharding import progressive_step

    planes = _planes()
    hists = progressive_step(*planes, size=(64, 96), device=torch.device("cpu"))
    assert entry.judge(planes, hists, (64, 96)) == {"hist_bins_off": 0.0}
    from jpeglibrary_tpu_torch.host.models.progressive_encoder import SCRIPT_3

    assert [tuple(s) for s in SCRIPT_3] == [tuple(s) for s in ref.SCRIPT_3]


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_planted_faults_are_not_correct(fault):
    """Each fault in the reference's place reads over the limit at a small
    size: a flat luma past 0x7FFF blocks for the unsplit runs, photo
    content for the others."""
    if fault == "runs_not_split":
        planes = [torch.zeros((2, 2, 16400, 64), dtype=torch.int16),
                  torch.zeros((2, 1, 8200, 64), dtype=torch.int16),
                  torch.zeros((2, 1, 8200, 64), dtype=torch.int16)]
        size = (16, 8 * 16400)
    else:
        planes, size = _planes(h=48, w=320), (48, 320)
    numbers = entry.judge(planes, ref.histograms(planes, size, fault=fault), size)
    assert numbers["hist_bins_off"] > LIMITS["hist_bins_off"]


def test_control_is_not_correct():
    """The reference counting in int16 wraps where a bin passes 32,767."""
    planes = [torch.zeros((1, 4, 16400, 64), dtype=torch.int16),
              torch.zeros((1, 2, 8200, 64), dtype=torch.int16),
              torch.zeros((1, 2, 8200, 64), dtype=torch.int16)]
    size = (32, 8 * 16400)
    control = ref.histograms(planes, size, count_dtype=torch.int16)
    assert entry.judge(planes, control, size)["hist_bins_off"] > LIMITS["hist_bins_off"]


def test_calibration_reads_the_same_numbers_on_both_sides(tmp_path):
    """``calibrate_prog.readings`` at the tiny cell: the program reads 0, both
    sides read each fault and the pool's density, so ``calibrate.main``'s
    summary has both readings of every number."""
    from jpegbench import calibrate_prog

    root = _checkout(tmp_path)
    cpu = torch.device("cpu")
    program = calibrate_prog.readings(TINY, 5, False, device=cpu, root=root)
    control = calibrate_prog.readings(TINY, 5, True, device=cpu, root=root)
    assert set(program) == set(control)
    assert program["hist_bins_off"] == 0.0
    assert {f"fault.{f}.hist_bins_off" for f in ref.FAULTS} <= set(program)
    assert program["fault.arithmetic_shift.hist_bins_off"] > 0
    assert 20 < program["luma_nonzero_ac"] < 40 and program["file_bits_per_pixel"] > 1


# --- The readers on a recorded trace --------------------------------------------

K7 = "(anonymous namespace)::progressive_hist_kernel(Plan, int*)"
K7_STITCH = "(anonymous namespace)::progressive_eobrun_kernel(Chains, int*)"
FILL = "void at::native::vectorized_elementwise_kernel<4, FillFunctor<int>>()"


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _events(step="progressive_step", drop=()):
    """A 1,000 us window of 3 steps 100 us apart, each a ``jpegbench.step``
    around the program's ``step`` span, launching a fill (1 us), K7 three
    times (20, 6, 6) and its stitch (2, under ``<step>.eobrun``) back to
    back from t = 400 us; ``drop`` leaves out device records by correlation
    id."""
    events = [_span(WINDOW, 0, 1000)]
    corr, at = 0, 400.0
    for i in range(3):
        t = 100.0 * i
        events += [_span(STEP, t, 40), _span(step, t + 2, 30), _span(f"{step}.eobrun", t + 20, 5)]
        for k, (name, dur, ts) in enumerate([(FILL, 1, 4), (K7, 20, 6), (K7, 6, 8), (K7, 6, 10),
                                             (K7_STITCH, 2, 21)]):
            corr += 1
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": t + ts, "dur": 0.5, "args": {"correlation": corr}})
            if corr not in drop:
                events.append({"ph": "X", "cat": "kernel", "name": name, "ts": at, "dur": dur,
                               "args": {"correlation": corr}})
            at += dur
    return events


ENTRY = SimpleNamespace(traffic={"entry": "transcode_progressive"})


def _read(name, events, shape=SMALL, window=None):
    trace = None if events is None else Trace(events)
    return spec.metric_reader(name)(Context(ENTRY, shape, window, trace))


def _bound(name, shape=SMALL):
    return spec.metric_reader(name).__globals__["step_bound_s"](shape)


@pytest.mark.parametrize("drop", [(), (3,)], ids=["whole", "a_record_dropped"])
def test_readers_on_a_recorded_trace(drop):
    events = _events(drop=drop)
    assert _read("k7_roofline.prog", events) == pytest.approx(
        100 * _bound("k7_roofline.prog") / 34e-6)
    assert _read("launches_per_step.prog", events) == pytest.approx(5.0)
    assert _read("step_host_ms.prog", events) == pytest.approx(0.030)
    window = Window(start=0.0, seconds=1e-3, steps=3, dispatch_s=[2e-5] * 3)
    assert _read("step_roofline.prog", events, window=window) == pytest.approx(
        100 * 3 * _bound("step_roofline.prog") / 1e-3)
    assert _read("dispatch_ms.prog", events, window=window) == pytest.approx(0.020)
    busy = 3 * 35e-6 - (6e-6 if drop else 0.0)
    assert _read("device_idle_pct.prog", events, window=window) == pytest.approx(
        100 * (1 - busy / 1e-3))


def test_readers_read_none_in_a_run_of_another_entry():
    """A run of ``full_step`` (or a program without ``progressive_step``)
    opens no ``progressive_step`` span and launches no K7."""
    events = _events(step="full_step")
    events = [dict(e, name="symbol_hist_kernel") if e.get("name") in (K7, K7_STITCH) else e
              for e in events]
    window = Window(start=0.0, seconds=1e-3, steps=3, dispatch_s=[2e-5] * 3)
    for name in METRICS:
        assert _read(name, events, window=window) is None, name
        assert _read(name, None, window=window) is None, name


def test_bounds_counted_by_hand():
    """At the cell's shape: 32 x 378 x 504 luma blocks and 32 x 189 x 252 of
    each chroma, 9,144,576 blocks of 128 B; 32 x 11 x 256 int32 bins."""
    want = (9_144_576 * 128 + 32 * 11 * 256 * 4) / 3.35e12
    assert _bound("k7_roofline.prog", SHAPE) == pytest.approx(want)
    assert _bound("step_roofline.prog", SHAPE) == pytest.approx(want)
