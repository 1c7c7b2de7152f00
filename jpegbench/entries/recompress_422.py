"""Entry ``recompress_422``: the batch step of a re-encoding job over 4:2:2
images (camera originals), ``jpeglibrary_tpu_torch.parallel.sharding.
full_step``, on one device.

Set-up makes a pool of ``traffic["pool"]`` distinct batches of
``traffic["batch"]`` images on the device from the seed (the
configuration's ``content`` at its ``width`` x ``height``, padded to whole
16 x 8 MCUs, the chroma averaged 2 x 1, quantised at its ``quality``;
``generators/coefficients422.py``), then warms the step up on each batch
once. The window, what is kept and when it is judged are those of the
``recompress`` entry; the judge is ``reference/recompress_422.py``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..generators import coefficients422, content
from ..reference import recompress_422 as reference
from . import recompress


def shape(config: dict, traffic: dict) -> Dict[str, int]:
    """The step's sizes: images a batch, source pixels an image, luma
    blocks of the padded planes (``hb`` x ``wb``; each chroma is ``hb`` x
    ``wb / 2``)."""
    w, h = int(config["width"]), int(config["height"])
    pw, ph = coefficients422.padded(w, h)
    return {"batch": int(traffic["batch"]), "width": w, "height": h, "hb": ph // 8,
            "wb": pw // 8}


class Run(recompress.Run):
    """One run of a cell whose traffic names this entry."""

    def __init__(self, workload, seed: int, device: torch.device, tracer):
        super().__init__(workload, seed, device, tracer)
        self.shape = shape(workload.config, workload.traffic)

    def _batch(self, g: torch.Generator):
        make = content.KINDS[self.workload.config["content"]]
        s = self.shape
        per = max(1, recompress.CHUNK_PIXELS // (s["width"] * s["height"]))
        parts = [coefficients422.quantised_planes(
            make(g, min(per, s["batch"] - i), s["height"], s["width"]), self.qy, self.qc)
            for i in range(0, s["batch"], per)]
        return tuple(torch.cat(p) for p in zip(*parts))

    def check(self) -> List[Dict[str, float]]:
        """The numbers compared for each kept step, against the reference."""
        steps = {i: out for i, out in self.kept.values()}
        self.kept = {}
        return [reference.judge((*self.pool[i % len(self.pool)], self.qy, self.qc),
                                steps.pop(i))
                for i in sorted(steps)]
