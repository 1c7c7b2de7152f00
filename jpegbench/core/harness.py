"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (steps in the window), ``failed`` (judged steps whose
numbers pass a limit), ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with tracing ``breakdown``, and last ``check``: each number compared
beside its limit. The same numbers end standard error.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from . import spec
from .trace import Trace, Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "jpeglibrary_tpu")  # top-level module names
GIB = float(1 << 30)


class RunError(RuntimeError):
    """A run that must print no result."""


@dataclass
class Context:
    """What a per-layer metric's reader gets."""

    workload: spec.Workload
    shape: Dict[str, int]
    window: object  # the entry's window record: steps, seconds, dispatch_s
    trace: Optional[Trace]


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package that this process has loaded,
    by whole top-level name (a None entry blocks an import; it loads
    nothing)."""
    loaded = {name.split(".")[0] for name, module in list(sys.modules.items())
              if module is not None}
    return sorted(loaded & set(FORBIDDEN))


def card(chips: int) -> torch.device:
    """The first CUDA device; raises :class:`RunError` without the cards a cell asks for."""
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} devices, {torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def _peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def run(workload: str, seed: int, seconds: float, trace: bool, t0: float,
        root=spec.ROOT, device: Optional[torch.device] = None) -> dict:
    """The result record of one run; ``device`` None means the card, which
    must be there (tests pass a CPU device to drive the rest of a run).
    Raises :class:`RunError` where no result may be printed."""
    w = spec.load(workload, root)
    if device is None:
        device = card(w.chips)
    tracer = Tracer(trace)
    run_ = w.entry().Run(w, seed, device, tracer)
    t_imported = time.perf_counter()
    run_.setup()
    # Objects made so far are never garbage: keep the collector's full passes
    # from walking them inside the window.
    gc.collect()
    gc.freeze()
    print(f"setup: imports and device {t_imported - t0:.3f} s, pool and warm-up "
          f"{time.perf_counter() - t_imported:.3f} s", file=sys.stderr)
    setup_peak = _peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with tracer.profile():
        window = run_.window(seconds)
    window_peak = _peak(device)

    if trace:
        ctx = Context(w, run_.shape, window, tracer.trace)
        values = {m["name"]: spec.metric_reader(m["name"], root)(ctx) for m in w.per_layer}
        units = {m["name"]: m["unit"] for m in w.per_layer}
    else:
        values = dict(run_.end_to_end(window))
        values["setup_s"] = window.start - t0
        values["peak_mem_gib"] = window_peak / GIB
        units = {m["name"]: m["unit"] for m in w.end_to_end}
    metrics = {name: {"value": values[name], "unit": units[name]}
               for name in units if values.get(name) is not None}

    judged = run_.check()
    if not judged:
        raise RunError("no step's outputs were kept to judge")
    missing = set(w.limits) - set(judged[0])
    if missing:
        raise RunError(f"limits for numbers the entry does not give: {sorted(missing)}")
    worst = {k: max(n[k] for n in judged) for k in w.limits}
    failed = sum(any(n[k] > w.limits[k] for k in w.limits) for n in judged)

    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package were loaded: {found}")
    record = {"correct": failed == 0, "attempted": window.steps, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                  else device.type),
                         "count": w.chips, "memory_peak_bytes": max(setup_peak, window_peak)}}
    if trace:
        record["device"]["busy_s"] = tracer.trace.busy_s() if tracer.trace else None
        record["device"]["window_s"] = tracer.trace.window_s if tracer.trace else None
        if tracer.trace:
            record["breakdown"] = tracer.trace.breakdown()
    record["check"] = {k: {"value": worst[k], "limit": w.limits[k]} for k in sorted(w.limits)}
    return record


def emit(record: dict, out=None, err=None) -> None:
    """The numbers compared as the last lines of ``err`` (standard error),
    then the record as the last line of ``out`` (standard output)."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, c in record["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(record), file=out)
    out.flush()
