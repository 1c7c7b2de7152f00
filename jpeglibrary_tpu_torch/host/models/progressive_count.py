"""Pass 1 of the progressive encoder (``progressive_encoder.encode_progressive``)
on a device: the symbol count of a progressive scan script from the
per-image rows of ``parallel.sharding.progressive_step`` (K7 on the card),
summed per table class as the host count sums them. The tables built from
them, and so the bytes, are the host count's."""

from __future__ import annotations

import numpy as np
import torch


def progressive_frequencies(coeffs, size, sampling, script, table_ids, dc_freqs, ac_freqs, *,
                            device) -> None:
    """The host progressive encoder's pass 1 on ``device``: one image's
    component planes ``coeffs`` (numpy [Hb, Wb, 64] zig-zag, MCU-padded,
    at ``sampling``) through ``parallel.sharding.progressive_step``, each
    row added to the frequencies of its table class (``dc_freqs`` /
    ``ac_freqs``, numpy int64 [256] by table id) as the host count adds it. Raises
    ValueError where the planes' shapes do not give ``sampling``, and for
    more than three components."""
    if not 1 <= len(coeffs) <= 3 or len(coeffs) == 2:
        raise ValueError(f"K7 counts one or three components, got {len(coeffs)}")
    from ...ops import encode_stage
    from ...parallel.sharding import progressive_step

    planes = [torch.from_numpy(np.ascontiguousarray(c, dtype=np.int16))[None] for c in coeffs]
    planes += [None] * (3 - len(planes))
    if tuple(encode_stage.progressive_sampling(*planes)) != tuple(map(tuple, sampling)):
        raise ValueError(f"planes {[tuple(c.shape) for c in coeffs]} are not at sampling "
                         f"{list(sampling)}")
    hist = progressive_step(*planes, script=script, size=size, device=device)[0]
    hist = hist.cpu().numpy().astype(np.int64)
    _, plans = encode_stage.progressive_plan(script, len(coeffs))
    for c, plan in enumerate(plans):
        if plan.dc is not None:
            dc_freqs[table_ids[c]] += hist[plan.dc[1]]
        for *_, row in plan.ac:
            ac_freqs[table_ids[c]] += hist[row]
