"""The ``recompress_422`` entry and its cell ``recompress_24mp_422_b4`` on the
CPU: ``spec.load`` finds every file of the cell; a whole run of a tiny cell
of the entry (set-up, window, check); the program against
``reference/recompress_422.py`` at small sizes, and the faults planted in
the reference, put in the program's place, failing the cell's limits (the
chroma duplicated 2x2, the 2x1 box replaced by decimation, the luma walked
in (2, 2) MCUs); the control failing them too; the generator's
planes; the thirteen readers on made-up Chrome trace events, and their bounds
counted by hand at the cell's shape."""

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
from jpegbench.core.peaks import bound_s
from jpegbench.core.trace import STEP, WINDOW, Trace
from jpegbench.entries.recompress import Window
from jpegbench.generators import coefficients422, content
from jpegbench.reference import recompress_422 as ref
from jpegbench.reference import tables

CELL = "recompress_24mp_422_b4"
TINY = "tiny_422_b3"
SHAPE = {"batch": 4, "width": 6000, "height": 4000, "hb": 500, "wb": 750}
SMALL = {"batch": 1, "width": 16, "height": 8, "hb": 1, "wb": 2}  # 128 pixels
TRACED = ("k6_roofline.camera422", "k2_roofline.camera422", "k5_roofline.camera422",
          "k1_roofline.camera422", "launches_per_step.camera422", "step_host_ms.camera422",
          "decode_stage_pct.camera422", "color_pct.camera422", "encode_stage_pct.camera422",
          "stats_pct.camera422")  # read from the program's spans and the device's kernels
HOST = ("step_roofline.camera422", "device_idle_pct.camera422", "dispatch_ms.camera422")
METRICS = TRACED + HOST
STAGES = ("decode_stage_pct", "color_pct", "encode_stage_pct", "stats_pct")
SEED = 2**31 + 2424  # larger than 32 signed bits hold, as a benchmark run's seeds may be
LIMITS = json.loads((ROOT / f"jpegbench/limits/{CELL}.json").read_text())


def _checkout(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout with the benchmark's files and a cell ``tiny_422_b3`` of
    the entry: the camera configuration at 72 x 40 (a ragged MCU column,
    padded to 80 x 40), 3 images a step, a pool of 2, the cell's limits;
    the new metrics list it."""
    shutil.copytree(ROOT / "jpegbench", tmp / "jpegbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "jpegbench/configs/camera_24mp_422_q95.json").read_text())
    config.update(width=72, height=40)
    (tmp / "jpegbench/configs/tiny_422.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "tiny_422", "source": "test",
                             "file": "jpegbench/configs/tiny_422.json", "reduced": [],
                             "why": "a CPU test's size"})
    bench["workloads"].append({"name": TINY, "config": "tiny_422", "traffic": "r422_b3",
                               "chips": 1, "why": "a CPU test's size"})
    (tmp / "jpegbench/traffic/r422_b3.json").write_text(json.dumps(
        {"entry": "recompress_422", "batch": 3, "pool": 2, "in_flight": 2}))
    shutil.copy(ROOT / f"jpegbench/limits/{CELL}.json", tmp / f"jpegbench/limits/{TINY}.json")
    for m in bench["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append(TINY)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def test_spec_finds_every_file_of_the_cell():
    from jpegbench.entries.recompress_422 import Run, shape

    w = spec.load(CELL)
    assert w.chips == 1 and w.traffic["entry"] == "recompress_422"
    assert w.entry().Run is Run and shape(w.config, w.traffic) == SHAPE
    assert w.config["name"] == "camera_24mp_422_q95" and w.config["reduced"] == []
    assert w.config["subsampling"] == "4:2:2" and w.config["quality"] == 95
    assert (w.traffic["batch"], w.traffic["pool"], w.traffic["in_flight"]) == (4, 4, 8)
    assert w.limits == LIMITS
    assert {m["name"] for m in w.end_to_end} == {"recompress_mp_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in w.per_layer} == set(METRICS)
    for name in METRICS:
        assert callable(spec.metric_reader(name))


def _run(root, trace):
    return harness.run(TINY, SEED, 0.3, trace, time.perf_counter(), root=root,
                       device=torch.device("cpu"))


def test_tiny_cell_runs_end_to_end(tmp_path):
    root = _checkout(tmp_path)
    record = _run(root, trace=False)
    assert record["correct"] and record["failed"] == 0 and record["attempted"] > 0
    assert set(record["metrics"]) == {"recompress_mp_s", "setup_s", "peak_mem_gib"}
    assert set(record["check"]) == set(LIMITS)
    traced = _run(root, trace=True)
    # The CPU launches no kernel: only what the host reads is there.
    assert traced["correct"] and set(traced["metrics"]) == set(HOST)
    assert traced["metrics"]["step_roofline.camera422"]["value"] > 0


def test_limits_name_what_judge_returns():
    inputs = _inputs(n=1, h=16, w=32)
    numbers = ref.judge(inputs, ref.step(*inputs))
    assert numbers == {k: 0.0 for k in numbers}
    assert set(LIMITS) <= set(numbers) and LIMITS["luma_hist_bins_off"] == 0


def _inputs(kind="photo", quality=95, n=2, h=64, w=96, seed=3):
    g = torch.Generator().manual_seed(seed)
    qy, qc = (torch.from_numpy(q) for q in tables.quant_tables_zz(quality))
    y, cb, cr = coefficients422.quantised_planes(content.KINDS[kind](g, n, h, w), qy, qc)
    return y, cb, cr, qy, qc


# (images, height, width): odd MCU rows and columns, a ragged strip of K6.
SIZES = [(2, 40, 80), (1, 72, 144), (3, 24, 272)]


@pytest.mark.parametrize("n,h,w", SIZES, ids=["x".join(map(str, s)) for s in SIZES])
def test_full_step_agrees_with_the_reference(n, h, w):
    from jpeglibrary_tpu_torch.parallel.sharding import full_step

    inputs = _inputs(n=n, h=h, w=w, seed=n + h)
    numbers = ref.judge(inputs, full_step(*inputs, device="cpu"))
    assert all(numbers[k] <= LIMITS[k] for k in LIMITS), numbers


def _upsample_2x2(plane):
    """The chroma duplicated 2x2, as at 4:2:0: luma row y takes chroma row
    y // 2, cut to the plane's height."""
    return plane.repeat_interleave(2, dim=-2)[:, :plane.shape[1]].repeat_interleave(2, dim=-1)


FAULTS = {
    "chroma_duplicated_2x2": ("upsample", _upsample_2x2),
    "box_by_decimation": ("box", lambda plane: plane[..., ::2]),
    "luma_walk_2x2": ("LUMA_MCU", (2, 2)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("seed", [1, 2])
def test_planted_faults_are_not_correct(monkeypatch, fault, seed):
    """Each fault, planted in the reference and put in the program's place,
    fails the cell's limits at a small size of the cell's content and
    tables."""
    inputs = _inputs(n=2, h=96, w=192, seed=seed)
    with monkeypatch.context() as m:
        m.setattr(ref, *FAULTS[fault])
        outputs = ref.step(*inputs)
    numbers = ref.judge(inputs, outputs)
    assert any(numbers[k] > LIMITS[k] for k in LIMITS), numbers


def test_raster_walk_is_the_422_walk():
    """A (2, 1) MCU is two blocks of one block row, so on whole MCU columns
    its walk is the raster walk of a (1, 1) MCU: walking the luma in (1, 1)
    MCUs is no fault at 4:2:2, and no limit could tell it apart."""
    y = _inputs(n=2, h=24, w=64)[0]
    assert torch.equal(ref.mcu_order(y, 2, 1), ref.mcu_order(y, 1, 1))
    assert not torch.equal(ref.mcu_order(y[:, :2], 2, 2), ref.mcu_order(y[:, :2], 2, 1))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(seed):
    """The reference with its products in TF32 fails the cell's limits."""
    inputs = _inputs(n=2, h=128, w=192, seed=seed)
    numbers = ref.judge(inputs, ref.step(*inputs, precision="tf32"))
    assert any(numbers[k] > LIMITS[k] for k in LIMITS), numbers


def test_reference_refuses_other_samplings():
    y, cb, cr, qy, qc = _inputs(n=1, h=16, w=32)
    half = cb[:, ::2]  # 4:2:0's chroma rows
    with pytest.raises(ValueError, match="4:2:2"):
        ref.step(y, half, half, qy, qc)


def test_generator_planes_and_padding():
    """[n, Hb, Wb, 64] luma and [n, Hb, Wb/2, 64] chroma over the image
    padded to whole 16 x 8 MCUs by its last row and column; the chroma the
    mean of each horizontal pair; the same seed gives the same planes."""
    assert coefficients422.padded(6000, 4000) == (6000, 4000)
    assert coefficients422.padded(72, 41) == (80, 48)
    qy, qc = (torch.from_numpy(q) for q in tables.quant_tables_zz(95))
    g = torch.Generator().manual_seed(SEED)
    rgb = content.photo(g, 2, 41, 72)
    y, cb, cr = coefficients422.quantised_planes(rgb, qy, qc)
    assert (tuple(y.shape), tuple(cb.shape), tuple(cr.shape)) == (
        (2, 6, 10, 64), (2, 6, 5, 64), (2, 6, 5, 64))
    assert y.dtype == cb.dtype == torch.int16
    flat = torch.full((1, 8, 32, 3), 200, dtype=torch.uint8)
    flat[:, :, 1::2, 2] = 100  # blue alternates column by column: only the box evens it out
    y, cb, cr = coefficients422.quantised_planes(flat, qy, qc)
    assert (cb[..., 1:] == 0).all() and (cr[..., 1:] == 0).all()  # flat after the box
    again = coefficients422.quantised_planes(content.photo(torch.Generator().manual_seed(SEED),
                                                           2, 41, 72), qy, qc)
    assert all(torch.equal(a, b) for a, b in zip(again, coefficients422.quantised_planes(
        rgb, qy, qc)))


# --- The readers on a recorded trace --------------------------------------------

K1 = "void (anonymous namespace)::dequant_idct_kernel<short, 64>(short const*, int const*)"
K6_420 = "void (anonymous namespace)::color_round_trip_kernel<2>(int4 const*, int4 const*)"
K6_422 = "void (anonymous namespace)::color_round_trip_kernel<1>(int4 const*, int4 const*)"
K2 = "void (anonymous namespace)::fdct_quant_kernel<unsigned char, 2, 1>(unsigned char const*)"
K5 = "void (anonymous namespace)::symbol_hist_kernel<short>(Planes, Walk)"
FILL = "void at::native::vectorized_elementwise_kernel<4, FillFunctor<int>>()"


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _events(k6=K6_422, drop=()):
    """A 1,000 us window of 3 steps 100 us apart, each a ``jpegbench.step``
    around the program's ``full_step`` span and its stages, launching K1 (40
    us), ``k6`` (20), K2 (30), a fill (1) and K5 (10) back to back on the
    device from t = 400 us; ``drop`` leaves out device records by
    correlation id."""
    events = [_span(WINDOW, 0, 1000)]
    corr, at = 0, 400.0
    stages = [("decode", [(K1, 40)]), ("to_rgb", [(k6, 20)]), ("fdct", [(K2, 30)]),
              ("stats", [(FILL, 1), (K5, 10)])]
    for i in range(3):
        t = 100.0 * i
        events += [_span(STEP, t, 40), _span("full_step", t + 2, 30)]
        for j, (stage, kernels) in enumerate(stages):
            events.append(_span(f"full_step.{stage}", t + 3 + 5 * j, 5))
            for k, (name, dur) in enumerate(kernels):
                corr += 1
                events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                               "ts": t + 4 + 5 * j + k, "dur": 0.5, "args": {"correlation": corr}})
                if corr not in drop:
                    events.append({"ph": "X", "cat": "kernel", "name": name, "ts": at,
                                   "dur": dur, "args": {"correlation": corr}})
                at += dur
    return events


ENTRY = SimpleNamespace(traffic={"entry": "recompress_422"})  # what a reader sees of the cell


def _read(name, events, shape=SMALL, window=None, workload=ENTRY):
    trace = None if events is None else Trace(events)
    return spec.metric_reader(name)(Context(workload, shape, window, trace))


def _bound(name, shape=SMALL):
    return spec.metric_reader(name).__globals__["step_bound_s"](shape)


@pytest.mark.parametrize("drop", [(), (3,)], ids=["whole", "a_record_dropped"])
def test_readers_on_a_recorded_trace(drop):
    events = _events(drop=drop)
    for name, us in (("k1_roofline.camera422", 40), ("k6_roofline.camera422", 20),
                     ("k2_roofline.camera422", 30), ("k5_roofline.camera422", 10)):
        assert _read(name, events) == pytest.approx(100 * _bound(name) / (us * 1e-6)), name
    assert _read("launches_per_step.camera422", events) == pytest.approx(5.0)
    window = Window(start=0.0, seconds=1e-3, steps=3, dispatch_s=[2e-5, 2e-5, 2e-5])
    assert _read("step_roofline.camera422", events, window=window) == pytest.approx(
        100 * 3 * _bound("step_roofline.camera422") / 1e-3)
    assert _read("step_roofline.camera422", events, window=Window(0.0, 0.0, 0)) is None
    # The 4:2:2 step's bound: a run of another entry reads nothing.
    other = SimpleNamespace(traffic={"entry": "recompress"})
    assert _read("step_roofline.camera422", events, window=window, workload=other) is None


@pytest.mark.parametrize("drop", [(), (3,)], ids=["whole", "a_record_dropped"])
def test_readers_of_the_recompress_cells_wrapped(drop):
    """The idle, dispatch, host and stage readers of the 4:2:2 cell read what
    their ``.recompress`` readers read, and None in a run of another entry."""
    events = _events(drop=drop)
    window = Window(start=0.0, seconds=1e-3, steps=3, dispatch_s=[2e-5, 2.4e-5, 2.2e-5])
    other = SimpleNamespace(traffic={"entry": "recompress"})
    for base in ("device_idle_pct", "dispatch_ms", "step_host_ms") + STAGES:
        want = _read(f"{base}.recompress", events, window=window)
        assert want is not None, base
        assert _read(f"{base}.camera422", events, window=window) == pytest.approx(want), base
        assert _read(f"{base}.camera422", events, window=window, workload=other) is None, base
    assert _read("dispatch_ms.camera422", events, window=window) == pytest.approx(0.022)
    assert _read("step_host_ms.camera422", events) == pytest.approx(0.030)
    # K1 40 us, K6 20, K2 30, a fill 1 and K5 10 a step; ``drop`` takes the
    # first step's K2 record, and the step that lost it is left out of the
    # shares.
    shares = {base: _read(f"{base}.camera422", events) for base in STAGES}
    assert shares == pytest.approx({"decode_stage_pct": 4000 / 101, "color_pct": 2000 / 101,
                                    "encode_stage_pct": 3000 / 101, "stats_pct": 1100 / 101})
    busy = 3 * 101e-6 - (30e-6 if drop else 0.0)
    assert _read("device_idle_pct.camera422", events) == pytest.approx(100 * (1 - busy / 1e-3))


def test_k6_reader_reads_the_422_instantiation_alone():
    """A 4:2:0 step's K6 (``color_round_trip_kernel<2>``) or a program whose
    K6 has no 4:2:2 instantiation gives ``k6_roofline.camera422`` nothing to
    read; no trace, no reading from any kernel reader."""
    assert _read("k6_roofline.camera422", _events(k6=K6_420)) is None
    parent = "void (anonymous namespace)::color_round_trip_kernel(int4 const*, int4 const*)"
    assert _read("k6_roofline.camera422", _events(k6=parent)) is None
    for name in TRACED:
        assert _read(name, None) is None


def test_bounds_counted_by_hand():
    """At the cell's shape: 96,000,000 luma pixels, 1,500,000 luma blocks
    and 750,000 of each chroma.

    - K6: 14 B a pixel, 1,344,000,000 B; 32 operations a pixel and 17 a
      2 x 1 cell (48,000,000 cells).
    - K1: 128 B in and 256 B out a block, and a 256 B table a launch:
      1,152,000,768 B; a 2 x 64 x 64 product and 2 operations a sample.
    - K2: 3 planes of 96,000,000 B in, 256 B tables, 384,000,000 B of
      coefficients out: 672,000,768 B; the box add per sample, 2 per
      coefficient.
    - K5: 384,000,000 B of blocks in, 2 x 2,048 B out, a test a
      coefficient.
    - The step: 9 B a pixel, 864,000,000 B.
    """
    pixels, blocks = 96_000_000, 3_000_000
    assert _bound("k6_roofline.camera422", SHAPE) == pytest.approx(
        bound_s(1_344_000_000, 0, pixels * 32 + 48_000_000 * 17))
    k1 = sum(bound_s(n * 384 + 256, n * 8192, n * 128) for n in (1_500_000, 750_000, 750_000))
    assert _bound("k1_roofline.camera422", SHAPE) == pytest.approx(k1)
    k2 = sum(bound_s(pixels + 256 + n * 128, n * 8192, pixels + n * 128)
             for n in (1_500_000, 750_000, 750_000))
    assert _bound("k2_roofline.camera422", SHAPE) == pytest.approx(k2)
    assert _bound("k2_roofline.camera422", SHAPE) == pytest.approx(672_000_768 / 3.35e12)
    assert _bound("k5_roofline.camera422", SHAPE) == pytest.approx(
        bound_s(192_002_048, 0, 96_000_000) + bound_s(192_002_048, 0, 96_000_000))
    assert _bound("k5_roofline.camera422", SHAPE) == pytest.approx(384_004_096 / 3.35e12)
    assert _bound("step_roofline.camera422", SHAPE) == pytest.approx(864_000_000 / 3.35e12)
    assert _bound("k6_roofline.camera422", SHAPE) == pytest.approx(1_344_000_000 / 3.35e12)
    assert blocks * 64 == 2 * pixels
