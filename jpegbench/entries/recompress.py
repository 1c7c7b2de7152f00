"""Entry ``recompress``: the batch step of a re-encoding job,
``jpeglibrary_tpu_torch.parallel.sharding.full_step``, on one device.

Set-up makes a pool of ``traffic["pool"]`` distinct batches of
``traffic["batch"]`` images on the device from the seed (the
configuration's ``content`` at its ``width`` x ``height``, padded to whole
MCUs, quantised at its ``quality``), then warms the step up on each batch
once. The window dispatches steps back to back from one host thread,
cycling over the pool, with at most ``traffic["in_flight"]`` steps queued
on the device, until ``seconds`` have passed, and ends with a synchronise.

The outputs of the last step of each pool batch, and of one step among the
first ``EARLY_STEPS`` that the seed draws, are kept and, once the window
has closed, judged against the plain reference (``reference.recompress``).
"""

from __future__ import annotations

import itertools
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from ..generators import coefficients, content
from ..reference import recompress as reference
from ..reference import tables

EARLY_STEPS = 64
CHUNK_PIXELS = 1 << 24  # pixels of content made in one set of calls


def shape(config: dict, traffic: dict) -> Dict[str, int]:
    """The step's sizes: images a batch, source pixels an image, luma
    blocks of the padded planes (``hb`` x ``wb``)."""
    w, h = int(config["width"]), int(config["height"])
    return {"batch": int(traffic["batch"]), "width": w, "height": h,
            "hb": coefficients.padded(h) // 8, "wb": coefficients.padded(w) // 8}


@dataclass
class Window:
    start: float  # host clock at the first dispatch
    seconds: float  # from the first dispatch to the end of the closing synchronise
    steps: int
    dispatch_s: List[float] = field(default_factory=list)  # host clock around each call


class Run:
    """One run of a cell whose traffic names this entry."""

    def __init__(self, workload, seed: int, device: torch.device, tracer):
        self.workload, self.seed, self.device, self.tracer = workload, seed, device, tracer
        self.shape = shape(workload.config, workload.traffic)
        qy, qc = tables.quant_tables_zz(int(workload.config["quality"]))
        self.qy, self.qc = (torch.from_numpy(q).to(device) for q in (qy, qc))
        self.pool = []
        self.kept = {}

    def _batch(self, g: torch.Generator):
        make = content.KINDS[self.workload.config["content"]]
        s = self.shape
        per = max(1, CHUNK_PIXELS // (s["width"] * s["height"]))
        parts = [coefficients.quantised_planes(make(g, min(per, s["batch"] - i), s["height"],
                                                    s["width"]), self.qy, self.qc)
                 for i in range(0, s["batch"], per)]
        return tuple(torch.cat(p) for p in zip(*parts))

    def step(self, i: int):
        """``full_step`` on pool batch ``i`` (modulo the pool)."""
        from jpeglibrary_tpu_torch.parallel.sharding import full_step

        y, cb, cr = self.pool[i % len(self.pool)]
        return full_step(y, cb, cr, self.qy, self.qc, device=self.device)

    def setup(self) -> None:
        """The pool from the seed, then one step on each of its batches."""
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        self.pool = [self._batch(g) for _ in range(int(self.workload.traffic["pool"]))]
        for i in range(len(self.pool)):
            self.step(i)
        _synchronize(self.device)

    def window(self, seconds: float) -> Window:
        early = random.Random(self.seed).randrange(EARLY_STEPS)
        # A host stall shorter than the queued steps' work leaves the card busy;
        # the host waits for the oldest beyond them.
        depth = int(self.workload.traffic["in_flight"])
        queued = [None] * depth
        dispatch = []
        with self.tracer.span("jpegbench.window"):
            start = time.perf_counter()
            end = start + seconds
            for i in itertools.count():
                if time.perf_counter() >= end:
                    break
                with self.tracer.span("jpegbench.pool"):
                    if queued[i % depth] is not None:
                        queued[i % depth].synchronize()
                t = time.perf_counter()
                with self.tracer.span("jpegbench.step"):
                    out = self.step(i)
                dispatch.append(time.perf_counter() - t)
                with self.tracer.span("jpegbench.pool"):
                    queued[i % depth] = _record(self.device)
                    # The newest output of each pool batch, and the seed's early step.
                    self.kept[i % len(self.pool)] = (i, out)
                    if i == early:
                        self.kept["early"] = (i, out)
            with self.tracer.span("jpegbench.sync"):
                _synchronize(self.device)
            stop = time.perf_counter()
        return Window(start, stop - start, len(dispatch), dispatch)

    def end_to_end(self, window: Window) -> Dict[str, float]:
        s = self.shape
        source_mp = s["batch"] * s["width"] * s["height"] * 1e-6
        return {"recompress_mp_s": window.steps * source_mp / window.seconds}

    def check(self) -> List[Dict[str, float]]:
        """The numbers compared for each kept step, against the reference."""
        steps = {i: out for i, out in self.kept.values()}
        self.kept = {}
        numbers = []
        for i in sorted(steps):
            inputs = (*self.pool[i % len(self.pool)], self.qy, self.qc)
            numbers.append(reference.judge(inputs, steps.pop(i)))
        return numbers


def _record(device: torch.device):
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(blocking=True)
    event.record()
    return event


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
