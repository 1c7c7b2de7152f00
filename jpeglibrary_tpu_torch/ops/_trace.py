"""Named spans around the port's device stages.

``span(name)`` marks a stage for whoever is listening: a running
``torch.profiler`` gets a ``record_function`` range (the span then lies in
the same Chrome trace as the CUDA runtime calls it holds and the device
records they launched), and the host stage table of
``host.utils.metrics``, when enabled, times it under the same name. With
neither on it returns one shared null context: a span then costs a
function call and two flag reads, and opens no ``record_function``.
"""

from __future__ import annotations

import contextlib

import torch

from ..host.utils import metrics

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around the stage ``name``: a profiler range while
    a torch profiler runs, a stage of the metrics table while it is
    enabled, both or neither."""
    profiling = torch._C._autograd._profiler_enabled()
    timing = metrics.enabled()
    if not (profiling or timing):
        return _OFF
    if not timing:
        return torch.profiler.record_function(name)
    if not profiling:
        return metrics.stage(name)
    return _both(name)


@contextlib.contextmanager
def _both(name: str):
    with torch.profiler.record_function(name), metrics.stage(name):
        yield
