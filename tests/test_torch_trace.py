"""PyTorch port, the spans of ``full_step`` on the CPU: under
``torch.profiler`` each call leaves one ``full_step`` span in the Chrome
trace with the four stage spans of ``_step`` inside it, in order, and
every op of the step after the first stage begins lies in a stage; the
metrics table sees the same names; with neither on, ``span`` is one
shared null context and the step opens no ``record_function``; the
outputs do not depend on tracing."""

import json

import pytest

torch = pytest.importorskip("torch")

from jpeglibrary_tpu_torch.graft_entry import _example_args
from jpeglibrary_tpu_torch.host.utils import metrics
from jpeglibrary_tpu_torch.ops import _trace
from jpeglibrary_tpu_torch.parallel import sharding

STAGES = ("full_step.decode", "full_step.to_rgb", "full_step.fdct", "full_step.stats")
CALLS = 2


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The outputs of ``CALLS`` profiled calls and the trace's complete
    events, in time order."""
    args = _example_args()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        outs = [sharding.full_step(*args, device="cpu") for _ in range(CALLS)]
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "ts" in e]
    return outs, sorted(events, key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))


def _spans(events, name):
    return [e for e in events if e.get("cat") == "user_annotation" and e["name"] == name]


def _holds(outer, inner) -> bool:
    a, b = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    return a <= float(inner["ts"]) and float(inner["ts"]) + float(inner.get("dur", 0)) <= b


def test_one_full_step_span_a_call(traced):
    _, events = traced
    assert len(_spans(events, "full_step")) == CALLS


@pytest.mark.parametrize("call", range(CALLS))
def test_stage_spans_lie_in_the_call_once_each_in_order(traced, call):
    _, events = traced
    outer = _spans(events, "full_step")[call]
    inside = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith("full_step.") and _holds(outer, e)]
    assert [e["name"] for e in inside] == list(STAGES)
    ends = [float(e["ts"]) + float(e["dur"]) for e in inside]
    assert all(end <= float(nxt["ts"]) for end, nxt in zip(ends, inside[1:]))


@pytest.mark.parametrize("call", range(CALLS))
def test_every_op_after_the_first_stage_lies_in_a_stage(traced, call):
    _, events = traced
    outer = _spans(events, "full_step")[call]
    stages = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] in STAGES and _holds(outer, e)]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")
           and _holds(outer, e) and float(e["ts"]) >= float(stages[0]["ts"])]
    assert ops
    stray = [e["name"] for e in ops if not any(_holds(s, e) for s in stages)]
    assert not stray, stray


def test_outputs_equal_with_and_without_the_profiler(traced):
    outs, _ = traced
    plain = sharding.full_step(*_example_args(), device="cpu")
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(out, plain))


@pytest.fixture
def metrics_off():
    was = metrics.enabled()
    metrics.enable(False)
    try:
        yield
    finally:
        metrics.enable(was)


def test_span_is_the_shared_null_context_when_nothing_listens(metrics_off):
    assert not torch._C._autograd._profiler_enabled()
    assert _trace.span("full_step") is _trace.span("full_step.decode") is _trace._OFF


def test_step_opens_no_record_function_when_nothing_listens(metrics_off, monkeypatch):
    opened = []

    def record_function(name, *a, **k):
        opened.append(name)
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", record_function)
    sharding.full_step(*_example_args(), device="cpu")
    assert opened == []


@pytest.mark.parametrize("profiled", [False, True], ids=["alone", "under_the_profiler"])
def test_metrics_table_sees_the_spans(metrics_off, profiled):
    metrics.reset()
    metrics.enable()
    try:
        if profiled:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                sharding.full_step(*_example_args(), device="cpu")
            names = [e.key for e in prof.key_averages()]
            assert {"full_step", *STAGES} <= set(names)
        else:
            sharding.full_step(*_example_args(), device="cpu")
        stages = metrics.snapshot()["stages"]
    finally:
        metrics.enable(False)
        metrics.reset()
    assert {"full_step", *STAGES} <= set(stages)
    assert all(stages[name]["count"] == 1 for name in ("full_step", *STAGES))
