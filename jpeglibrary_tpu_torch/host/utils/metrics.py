"""Lightweight per-stage metrics (SURVEY.md §5: the reference has no
observability; the TPU build adds throughput counters, per-stage
timings, and error counts).

Zero-overhead when disabled (the default). Enable globally with
``metrics.enable()`` or the JPX_METRICS=1 environment variable; read a
snapshot with ``metrics.snapshot()`` and reset with ``metrics.reset()``.

The decoder, scanners and device pipeline wrap their stages in
``metrics.stage("name")``; the bench and CLI can print the table.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Dict

_LOCK = threading.Lock()
_ENABLED = os.environ.get("JPX_METRICS", "") not in ("", "0", "false")


class _Stat:
    __slots__ = ("count", "total_s", "max_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0


_STAGES: Dict[str, _Stat] = {}
_COUNTERS: Dict[str, float] = {}


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


@contextmanager
def stage(name: str):
    """Time a pipeline stage (no-op when disabled)."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            st = _STAGES.get(name)
            if st is None:
                st = _STAGES[name] = _Stat()
            st.count += 1
            st.total_s += dt
            st.max_s = max(st.max_s, dt)


def count(name: str, value: float = 1.0) -> None:
    """Bump a counter (e.g. megapixels decoded, decode errors)."""
    if not _ENABLED:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0.0) + value


def snapshot() -> dict:
    with _LOCK:
        return {
            "stages": {
                name: {
                    "count": st.count,
                    "total_ms": round(st.total_s * 1e3, 3),
                    "mean_ms": round(st.total_s / st.count * 1e3, 3) if st.count else 0.0,
                    "max_ms": round(st.max_s * 1e3, 3),
                }
                for name, st in _STAGES.items()
            },
            "counters": dict(_COUNTERS),
        }


def reset() -> None:
    with _LOCK:
        _STAGES.clear()
        _COUNTERS.clear()


def report() -> str:
    """Human-readable table."""
    snap = snapshot()
    lines = []
    for name, st in sorted(snap["stages"].items()):
        lines.append(
            f"{name:32s} n={st['count']:<6d} mean={st['mean_ms']:9.3f} ms "
            f"total={st['total_ms']:10.3f} ms max={st['max_ms']:9.3f} ms"
        )
    for name, v in sorted(snap["counters"].items()):
        lines.append(f"{name:32s} {v}")
    return "\n".join(lines)
