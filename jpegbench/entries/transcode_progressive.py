"""Entry ``transcode_progressive``: the count pass of a lossless
progressive transcode (``jpegtran -copy none -optimize -progressive``),
``jpeglibrary_tpu_torch.parallel.sharding.progressive_step``, on one
device: the per-image Huffman symbol histograms of libjpeg's 10-scan
script over a batch of 4:2:0 coefficient planes.

Set-up makes a pool of ``traffic["pool"]`` distinct batches of
``traffic["batch"]`` images on the device from the seed (the
configuration's ``content`` at its ``width`` x ``height``, padded to whole
MCUs, quantised at its ``quality``: what a baseline original's entropy
decode hands the transcoder), then warms the step up on each batch once.
The window, what is kept and when it is judged are those of the
``recompress`` entry. The judge is ``reference/transcode_progressive.py``
on the card, one image at a time: ``hist_bins_off``, the bins of the
kept step's [B, 11, 256] that differ from the reference's count.

A program without ``progressive_step`` fails when the run is made, before
any set-up.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..core.peaks import bound_s
from ..reference import transcode_progressive as reference
from . import recompress

ROWS = 11  # the histogram rows of libjpeg's script: 3 DC first, 8 AC


def step_bound_s(shape) -> float:
    """The count pass's bound at the memory rate, the same whatever
    implements it: one read of the int16 zig-zag blocks (the luma and both
    quarter-size chroma planes, 128 B a block) and the write of the [B, 11,
    256] int32 histograms. ``k7_roofline.prog`` and ``step_roofline.prog``
    read against it."""
    b, hb, wb = shape["batch"], shape["hb"], shape["wb"]
    blocks = b * hb * wb + 2 * b * (hb // 2) * (wb // 2)
    return bound_s(blocks * 64 * 2 + b * ROWS * 256 * 4)


def judge(planes, hists: torch.Tensor, size, **reference_options) -> Dict[str, float]:
    """The numbers compared for one step: the bins of ``hists`` that differ
    from the reference's count of the same planes."""
    want = reference.histograms(planes, size, reference.SCRIPT_3, **reference_options)
    return {"hist_bins_off": float(reference.bins_off(hists, want))}


class Run(recompress.Run):
    """One run of a cell whose traffic names this entry."""

    def __init__(self, workload, seed: int, device: torch.device, tracer):
        from jpeglibrary_tpu_torch.parallel.sharding import progressive_step

        super().__init__(workload, seed, device, tracer)
        self.progressive_step = progressive_step
        self.size = (self.shape["height"], self.shape["width"])

    def step(self, i: int):
        """``progressive_step`` on pool batch ``i`` (modulo the pool)."""
        y, cb, cr = self.pool[i % len(self.pool)]
        return self.progressive_step(y, cb, cr, size=self.size, device=self.device)

    def check(self) -> List[Dict[str, float]]:
        """The numbers compared for each kept step, against the reference."""
        steps = {i: out for i, out in self.kept.values()}
        self.kept = {}
        return [judge(self.pool[i % len(self.pool)], steps.pop(i), self.size)
                for i in sorted(steps)]
