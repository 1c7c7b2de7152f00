"""The reading of a trace, on made-up Chrome trace events: the window,
the device's busy time, steps whole or with dropped records, rooflines
and the breakdown."""

import pytest

from jpegbench.core.trace import STEP, WINDOW, Trace, roofline_pct, union_s


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _events(drop=()):
    """A 1,000 us window of 3 steps, each launching a K1 (40 us) and an
    elementwise kernel (200 us), back to back from t = 100 us."""
    events = [_span(WINDOW, 0, 1000), {"ph": "M", "name": "process_name"}]
    corr = 0
    for i in range(3):
        events.append(_span(STEP, 10 * i, 5))
        events.append(_span("jpegbench.pool", 10 * i + 5, 7))
        for name, dur in (("dequant_idct_kernel<short>", 40),
                          ("void at::native::elementwise_kernel<at::native::AddFunctor<int>>", 200)):
            corr += 1
            events.append(_launch(10 * i + corr % 2, corr))
            start = 100 + 240 * i + (40 if "elem" in name else 0)
            if corr not in drop:
                events.append(_kernel(name, start, dur, corr))
    return events


def test_window_busy_and_gaps():
    t = Trace(_events())
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx(720e-6)
    assert t.gaps() == [(0.0, 100.0), (820.0, 1000.0)]
    assert union_s([(0, 2), (1, 3), (5, 6)], 0, 10) == 4


def test_steps_keep_only_whole_ones():
    assert [len(s) for s in Trace(_events()).steps()] == [2, 2, 2]
    assert [len(s) for s in Trace(_events(drop={3})).steps()] == [2, 2]


def test_roofline_over_whole_steps():
    # Bound 20 us a step against K1's 40 us: 50%, with or without a dropped K1.
    assert roofline_pct(Trace(_events()), "dequant_idct_kernel", 20e-6) == pytest.approx(50.0)
    assert roofline_pct(Trace(_events(drop={1})), "dequant_idct_kernel", 20e-6) == \
        pytest.approx(50.0)
    assert roofline_pct(Trace(_events()), "no_such_kernel", 20e-6) is None
    assert roofline_pct(None, "dequant_idct_kernel", 20e-6) is None


def test_breakdown_names_gaps_by_host_span():
    b = Trace(_events()).breakdown()
    assert b["device_ops"][0] == ["elementwise_kernel<AddFunctor<int>>", pytest.approx(600e-6)]
    # The longest gap (820-1000 us) lies under no harness span but the window's.
    assert b["idle_gaps"][0] == [WINDOW, pytest.approx(180e-6)]
    assert b["idle_gaps"][1][0] == "jpegbench.pool"  # 0-100 us: the pool's span covers most


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError, match=WINDOW):
        Trace([_span(STEP, 0, 1)])
