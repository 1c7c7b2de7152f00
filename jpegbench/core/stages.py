"""The program's own spans in a traced window: the stage of ``full_step``
that launched each device record.

``jpeglibrary_tpu_torch.parallel.sharding.full_step`` opens a span
``full_step`` around each call and, inside it, one span a stage
(:data:`STAGES`), as ``record_function`` ranges while the profiler runs.
Each device record of the trace's complete steps (:meth:`Trace.steps`)
goes to the innermost program span whose interval holds the CUDA runtime
call that launched it, tied by correlation id, as :meth:`Trace.steps` ties
it to ``jpegbench.step``. A program without these spans leaves the trace
with no ``full_step`` span, and every reader here returns None.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

from .trace import Trace, _interval

STEP_SPAN = "full_step"
STAGES = ("full_step.decode", "full_step.to_rgb", "full_step.to_ycbcr", "full_step.fdct",
          "full_step.stats")


@dataclass
class Step:
    """One complete step: its ``full_step`` span and, for each of its
    device records, the name of the innermost program span that launched
    it (None outside every one)."""

    span: Optional[dict]
    records: List[Tuple[dict, Optional[str]]]


def _innermost(spans: List[dict], times: List[float]) -> List[Optional[dict]]:
    """For each of the ascending ``times``, the innermost of the nested
    ``spans`` (sorted by start, the wider first at a tie) whose interval
    holds it, or None."""
    out, open_, i = [], [], 0
    for t in times:
        while i < len(spans) and float(spans[i]["ts"]) <= t:
            lo, _ = _interval(spans[i])
            while open_ and _interval(open_[-1])[1] < lo:
                open_.pop()
            open_.append(spans[i])
            i += 1
        while open_ and _interval(open_[-1])[1] < t:
            open_.pop()
        out.append(open_[-1] if open_ else None)
    return out


def steps(trace: Optional[Trace]) -> Optional[List[Step]]:
    """The complete steps with the program span of each device record;
    None without a trace or where it holds no ``full_step`` span."""
    if trace is None:
        return None
    spans = sorted((e for e in trace.spans
                    if e["name"] == STEP_SPAN or e["name"].startswith(STEP_SPAN + ".")),
                   key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
    calls = [e for e in spans if e["name"] == STEP_SPAN]
    if not calls:
        return None
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in trace.runtime
              if e.get("args", {}).get("correlation") is not None}
    complete = trace.steps()
    flat = sorted((launch[e["args"]["correlation"]], k, j)
                  for k, step in enumerate(complete) for j, e in enumerate(step))
    owner = _innermost(spans, [t for t, _, _ in flat])
    names: List[List[Optional[str]]] = [[None] * len(step) for step in complete]
    for (_, k, j), span in zip(flat, owner):
        names[k][j] = span["name"] if span is not None else None
    starts = [float(e["ts"]) for e in calls]
    out = []
    for step, step_names in zip(complete, names):
        first = min(launch[e["args"]["correlation"]] for e in step)
        i = bisect.bisect_right(starts, first) - 1
        call = calls[i] if i >= 0 and _interval(calls[i])[1] >= first else None
        out.append(Step(call, list(zip(step, step_names))))
    return out


def _kernel_us(records: Iterable[Tuple[dict, Optional[str]]], under=None) -> float:
    return sum(float(e.get("dur", 0.0)) for e, name in records
               if e["cat"] == "kernel" and (under is None or name in under))


def stage_pct(trace: Optional[Trace], stages: Tuple[str, ...]) -> Optional[float]:
    """The share of the complete steps' kernel time launched under
    ``stages``; None where there is nothing to read."""
    found = steps(trace)
    if not found:
        return None
    total = sum(_kernel_us(s.records) for s in found)
    if total <= 0.0:
        return None
    return 100.0 * sum(_kernel_us(s.records, stages) for s in found) / total


def launches_per_step(trace: Optional[Trace]) -> Optional[float]:
    """The device records launched under ``full_step`` or its stages, a
    complete step, as the mean over the complete steps."""
    found = steps(trace)
    if not found:
        return None
    return sum(sum(name is not None for _, name in s.records) for s in found) / len(found)


def step_host_ms(trace: Optional[Trace]) -> Optional[float]:
    """The mean duration of the complete steps' ``full_step`` spans, in ms."""
    found = [s.span for s in steps(trace) or () if s.span is not None]
    if not found:
        return None
    return 1e-3 * sum(float(e.get("dur", 0.0)) for e in found) / len(found)
