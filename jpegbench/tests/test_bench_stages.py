"""The reading of the program's spans (``core/stages.py``) and the six
metrics on it, on made-up Chrome trace events: each kernel goes to the
innermost program span around its launch, only complete steps count, and
a trace without program spans reads None."""

import pytest

from jpegbench.core import spec, stages
from jpegbench.core.harness import Context
from jpegbench.core.trace import STEP, WINDOW, Trace

METRICS = ("decode_stage_pct.recompress", "color_pct.recompress", "encode_stage_pct.recompress",
           "stats_pct.recompress", "launches_per_step.recompress", "step_host_ms.recompress")
SHARES = METRICS[:4]

# Per stage: its span's offset and length within the step (us), and the
# device records it launches (category, name, duration in us).
STAGE_WORK = (
    ("full_step.decode", 2, 8, (("kernel", "dequant_idct_kernel<short>", 30),
                                ("kernel", "elementwise_kernel<AddFunctor<int>>", 20))),
    ("full_step.to_rgb", 11, 8, (("kernel", "elementwise_kernel<AddFunctor<int>>", 100),)),
    ("full_step.to_ycbcr", 21, 7, (("kernel", "elementwise_kernel<AddFunctor<int>>", 80),)),
    ("full_step.fdct", 29, 7, (("kernel", "fdct_quant_kernel", 10),)),
    ("full_step.stats", 37, 8, (("gpu_memset", "Memset (Device)", 1),
                                ("kernel", "symbol_hist_kernel", 5))),
)
STEP_KERNEL_US = 245.0
RECORDS_PER_STEP = 7


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _events(drop=(), program=True, outside_stage=False):
    """A 5,000 us window of 3 steps 100 us apart. Step i's ``full_step``
    span lasts 48 + i us; each stage launches its records, which run back
    to back on the device from t = 1,000 us. ``drop`` leaves out device
    records by correlation id; ``program`` False leaves out every program
    span (a program without them); ``outside_stage`` adds a 15 us kernel
    launched in ``full_step`` before its first stage."""
    events = [_span(WINDOW, 0, 5000)]
    corr, at = 0, 1000.0

    def launch(ts, cat, name, dur):
        nonlocal corr, at
        corr += 1
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                       "dur": 0.5, "args": {"correlation": corr}})
        if corr not in drop:
            events.append({"ph": "X", "cat": cat, "name": name, "ts": at, "dur": dur,
                           "args": {"correlation": corr}})
        at += dur

    for i in range(3):
        t0 = 100 * i
        events.append(_span(STEP, t0, 50))
        if program:
            events.append(_span(stages.STEP_SPAN, t0 + 1, 48 + i))
        if outside_stage:
            launch(t0 + 1.5, "kernel", "direct_copy_kernel", 15)
        for name, off, length, work in STAGE_WORK:
            if program:
                events.append(_span(name, t0 + off, length))
            for j, (cat, kname, dur) in enumerate(work):
                launch(t0 + off + 1 + j, cat, kname, dur)
        events.append(_span("jpegbench.pool", t0 + 50, 20))
    return events


def _read(name, events):
    trace = Trace(events)
    return spec.metric_reader(name)(Context(None, {}, None, trace))


def test_kernels_go_to_their_stage_and_the_shares_sum_to_100():
    got = {m: _read(m, _events()) for m in SHARES}
    assert got["decode_stage_pct.recompress"] == pytest.approx(100 * 50 / STEP_KERNEL_US)
    assert got["color_pct.recompress"] == pytest.approx(100 * 180 / STEP_KERNEL_US)
    assert got["encode_stage_pct.recompress"] == pytest.approx(100 * 10 / STEP_KERNEL_US)
    assert got["stats_pct.recompress"] == pytest.approx(100 * 5 / STEP_KERNEL_US)
    assert sum(got.values()) == pytest.approx(100.0)


def test_a_kernel_goes_to_the_innermost_span():
    """A kernel launched in ``full_step`` outside every stage is the outer
    span's: it counts in the step's time and launches but in no stage."""
    found = stages.steps(Trace(_events(outside_stage=True)))
    assert [n for _, n in found[0].records] == [stages.STEP_SPAN] + [
        name for name, _, _, work in STAGE_WORK for _ in work]
    shares = sum(_read(m, _events(outside_stage=True)) for m in SHARES)
    assert shares == pytest.approx(100 * STEP_KERNEL_US / (STEP_KERNEL_US + 15))
    assert _read("launches_per_step.recompress", _events(outside_stage=True)) == \
        RECORDS_PER_STEP + 1


def test_a_step_with_a_dropped_record_is_left_out():
    # Correlation id 8 is step 1's first record (7 a step).
    found = stages.steps(Trace(_events(drop={8})))
    assert [s.span["dur"] for s in found] == [48, 50]
    assert sum(_read(m, _events(drop={8})) for m in SHARES) == pytest.approx(100.0)
    assert _read("decode_stage_pct.recompress", _events(drop={8})) == \
        pytest.approx(100 * 50 / STEP_KERNEL_US)


def test_launches_and_host_time_read_as_built():
    assert _read("launches_per_step.recompress", _events()) == RECORDS_PER_STEP
    assert _read("step_host_ms.recompress", _events()) == pytest.approx(49e-3)
    assert _read("step_host_ms.recompress", _events(drop={8})) == pytest.approx(49e-3)
    assert _read("step_host_ms.recompress", _events(drop={1})) == pytest.approx(49.5e-3)


@pytest.mark.parametrize("name", METRICS)
def test_reads_none_without_program_spans(name):
    assert _read(name, _events(program=False)) is None
    assert spec.metric_reader(name)(Context(None, {}, None, None)) is None
