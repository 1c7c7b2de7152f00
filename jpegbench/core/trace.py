"""The harness's spans and its reading of ``torch.profiler``'s trace.

Spans are ``record_function`` ranges named ``jpegbench.<what>``, recorded
from the harness's own files around its calls into the program; with
tracing off they cost nothing. With tracing on, the window runs under
``torch.profiler`` (CPU and CUDA activities), and its Chrome trace is
read back as a :class:`Trace`: the device's kernels, copies and fills,
the harness's spans, and the CUDA runtime calls that tie each device
record to the span it was launched in.

CUPTI on the H100 drops device records now and then, at times a whole
window's. A reader of single launches therefore keeps only the steps
that hold as many device records as the fullest step (:meth:`Trace.steps`):
every step of a window does the same work.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "jpegbench.window"
STEP = "jpegbench.step"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 64  # of a device operation's name in the breakdown
# Left out of those names, so that the functor that tells two kernels apart fits.
NAME_NOISE = ("void ", "at::native::", "(anonymous namespace)::", "at_cuda_detail::")


class Tracer:
    """Spans, and the profiler over the window when ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.trace: Optional[Trace] = None

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.on else contextlib.nullcontext()

    @contextlib.contextmanager
    def profile(self):
        """The window: profiled when on; the trace lands in ``self.trace``."""
        if not self.on:
            yield
            return
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            yield
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = Trace(json.load(f)["traceEvents"])
        finally:
            os.remove(path)


def union_s(intervals, lo: float, hi: float) -> float:
    """The time within [lo, hi] that the union of (start, end) intervals
    covers, each instant once (in the intervals' unit)."""
    total, at = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, at), min(b, hi)
        if b > a:
            total += b - a
            at = b
    return total


def _interval(e) -> Tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


class Trace:
    """The events of one traced window (Chrome trace times: microseconds).

    Raises ``ValueError`` when the trace lacks the window's span."""

    def __init__(self, events: List[dict]):
        complete = [e for e in events if e.get("ph") == "X" and "ts" in e]
        windows = [e for e in complete if e.get("cat") == "user_annotation"
                   and e.get("name") == WINDOW]
        if len(windows) != 1:
            raise ValueError(f"the trace holds {len(windows)} {WINDOW} spans, not 1")
        self.lo, self.hi = _interval(windows[0])
        self.device = sorted((e for e in complete if e.get("cat") in DEVICE_CATEGORIES
                              and self.lo <= float(e["ts"]) < self.hi), key=lambda e: e["ts"])
        self.spans = sorted((e for e in complete if e.get("cat") == "user_annotation"
                             and e.get("name") != WINDOW), key=lambda e: e["ts"])
        self.runtime = sorted((e for e in complete if e.get("cat") in RUNTIME_CATEGORIES),
                              key=lambda e: e["ts"])

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def busy_s(self) -> float:
        """Seconds of the window in which some kernel, copy or fill ran."""
        return union_s([_interval(e) for e in self.device], self.lo, self.hi) * 1e-6

    def kernels(self) -> List[dict]:
        return [e for e in self.device if e["cat"] == "kernel"]

    def named(self, name: str) -> List[dict]:
        """The harness's spans of ``name``, in time order."""
        return [e for e in self.spans if e["name"] == name]

    def steps(self) -> List[List[dict]]:
        """For each complete ``jpegbench.step`` span, the device records it
        launched, tied by the CUDA runtime call's correlation id; a step is
        complete when it holds as many as the fullest step."""
        by_corr: Dict[int, dict] = {}
        for e in self.device:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                by_corr[corr] = e
        starts = [float(e["ts"]) for e in self.runtime]
        launched = []
        for span in self.named(STEP):
            lo, hi = _interval(span)
            calls = self.runtime[bisect.bisect_left(starts, lo):bisect.bisect_right(starts, hi)]
            launched.append([by_corr[c] for c in (e.get("args", {}).get("correlation")
                                                  for e in calls) if c in by_corr])
        fullest = max((len(x) for x in launched), default=0)
        return [x for x in launched if fullest and len(x) == fullest]

    def gaps(self) -> List[Tuple[float, float]]:
        """The window's intervals in which the device ran nothing."""
        out, at = [], self.lo
        for a, b in sorted(_interval(e) for e in self.device):
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.hi > at:
            out.append((at, self.hi))
        return out

    def host_span_at(self, lo: float, hi: float) -> str:
        """The harness span that covers most of [lo, hi], or the window's."""
        best, name = 0.0, WINDOW
        for e in self.spans:
            a, b = _interval(e)
            if a >= hi:
                break
            cover = min(b, hi) - max(a, lo)
            if cover > best:
                best, name = cover, e["name"]
        return name

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing, in seconds."""
        by_name: Dict[str, float] = {}
        for e in self.device:
            key = e["name"]
            for noise in NAME_NOISE:
                key = key.replace(noise, "")
            key = key[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + float(e.get("dur", 0.0)) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:BREAKDOWN_ENTRIES]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.host_span_at(a, b), (b - a) * 1e-6] for a, b in gaps]}


def roofline_pct(trace: Optional[Trace], kernel: str, step_bound_s: float) -> Optional[float]:
    """The share of its bound that a kernel reaches over the trace's
    complete steps: steps x ``step_bound_s`` over the time of the kernels
    whose names hold ``kernel`` in those steps; None where there is
    nothing to read."""
    steps = trace.steps() if trace is not None else []
    busy = sum(float(e.get("dur", 0.0)) for step in steps for e in step
               if e["cat"] == "kernel" and kernel in e["name"]) * 1e-6
    if not steps or busy <= 0.0:
        return None
    return 100.0 * len(steps) * step_bound_s / busy
