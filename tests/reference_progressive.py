"""Plain PyTorch reference for the symbol statistics of a progressive JPEG's
scan script (ITU-T T.81 G.1.2.2 and G.1.2.3), per image and per scan.

Imports nothing of the program. Each image's counts are worked out on
their own in int64, with cumulative sums for the runs and no loop over
blocks. The rules are those of a progressive Huffman emitter in count
mode (libjpeg's ``jcphuff.c``, the port's native ``jpx_encode_prog_*``):

- DC first (Ah = 0): along each component's interleaved MCU chain, the
  category of ``(dc >> Al) - (previous dc >> Al)`` (an arithmetic shift),
  from 0 at each image's first MCU. DC refinement codes raw bits only.
- AC first (Ah = 0), band [Ss, Se], magnitudes ``|v| >> Al`` (a magnitude
  shift): for each non-zero magnitude ``z // 16`` ZRLs (0xF0) and
  ``((z % 16) << 4) | cat``, ``z`` the zeros since the last non-zero.
- AC refinement (Ah = Al + 1): ``t = |v| >> Al``. Only ``t == 1`` (newly
  significant) codes a symbol, ``(z % 16) << 4 | 1`` after ``z // 16``
  ZRLs, where ``z`` counts the positions with ``t == 0`` alone;
  ``t > 1`` (a correction bit) codes none.
- EOB runs (both AC kinds): a block whose band holds positions after its
  last symbol joins the run; a block that codes a symbol first flushes
  the run pending before it. A run of L blocks codes ``L // 32767``
  symbols 0xE0 and, if ``L % 32767 > 0``, ``floor(log2(L % 32767)) << 4``.
  The run is flushed at each image's end (no restart intervals).

AC scans walk a component's own block grid, ``ceil(Xi/8) x ceil(Yi/8)``
blocks in raster order (T.81 A.2.2); DC scans walk the interleaved MCU
chain over the padded plane.

``histograms`` returns ``[B, R, 256]`` counts: one row per (scan,
component) that codes Huffman symbols, in script order. ``FAULTS`` are
deliberate errors that a judge must see, put in the program's place.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

MAX_EOB_RUN = 0x7FFF
SEGMENT = 32  # blocks of a row that the card's kernel reads as one run of lanes

# (components, Ss, Se, Ah, Al): libjpeg's jpeg_simple_progression for
# three-component YCbCr, with Cb's scans before Cr's.
SCRIPT_3 = [
    ((0, 1, 2), 0, 0, 0, 1),
    ((0,), 1, 5, 0, 2),
    ((1,), 1, 63, 0, 1),
    ((2,), 1, 63, 0, 1),
    ((0,), 6, 63, 0, 2),
    ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0),
    ((1,), 1, 63, 1, 0),
    ((2,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0),
]
SAMPLING_420 = ((2, 2), (1, 1), (1, 1))

FAULTS = (
    "arithmetic_shift",      # the AC point transform as v >> Al, not |v| >> Al
    "runs_not_stitched",     # the EOB runs across a 32-block segment's ends lost
    "runs_not_split",        # a run of any length as one symbol
    "chains_not_restarted",  # DC predictors and EOB runs carried into the next image
    "corrections_as_zeros",  # refinement runs counting correction positions
)


def rows(script) -> List[Tuple[int, int]]:
    """(scan index, component) of each histogram row, in script order."""
    out = []
    for i, (comps, ss, _se, ah, _al) in enumerate(script):
        if ss == 0:
            if ah == 0:
                out.extend((i, c) for c in comps)
        else:
            out.append((i, comps[0]))
    return out


def _bits(a: torch.Tensor) -> torch.Tensor:
    """The bit length of each non-negative int64."""
    return torch.frexp(a.to(torch.float64))[1].to(torch.int64)


def _bincount(values: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return torch.bincount(values.reshape(-1), None if weights is None else weights.reshape(-1),
                          minlength=256)[:256].to(torch.int64)


def _eob_symbols(lengths: torch.Tensor, fault: Optional[str]) -> torch.Tensor:
    """The histogram of the EOB-run symbols of runs of ``lengths`` blocks."""
    lengths = lengths[lengths > 0]
    hist = torch.zeros(256, dtype=torch.int64, device=lengths.device)
    if fault == "runs_not_split":
        return hist + _bincount(_bits(lengths) - 1 << 4)
    hist[0xE0] += int((lengths // MAX_EOB_RUN).sum())
    rest = lengths % MAX_EOB_RUN
    rest = rest[rest > 0]
    return hist + _bincount(_bits(rest) - 1 << 4)


def _eob_runs(joins: torch.Tensor, codes: torch.Tensor, cuts: torch.Tensor, carry: int,
              fault: Optional[str]):
    """The EOB-run histogram of a chain of blocks, given which blocks join a
    run and which code a symbol (and flush the run pending before them),
    with ``carry`` blocks pending from before the chain. Returns
    (histogram, the run still pending at the chain's end). ``cuts`` marks
    the first block of each segment, where the fault ``runs_not_stitched``
    loses the runs that cross it."""
    flush = codes | cuts
    before = torch.cumsum(joins.to(torch.int64), 0) - joins.to(torch.int64)  # J of blocks < i
    total = int(joins.sum())
    at = before[flush]
    lengths = torch.diff(at, prepend=torch.zeros(1, dtype=torch.int64, device=at.device))
    if lengths.numel():
        lengths[0] += carry
        pending = total - int(at[-1])
    else:
        pending = total + carry
    if fault == "runs_not_stitched":  # only runs between two coding blocks of one segment
        coding, cut = codes[flush], cuts[flush]
        inside = coding & ~cut & torch.cat([torch.zeros_like(coding[:1]), coding[:-1]])
        lengths, pending = lengths[inside], 0
    return _eob_symbols(lengths, fault), pending


def _ac_scan(blocks: torch.Tensor, ss: int, se: int, ah: int, al: int, carry: int,
             cuts: torch.Tensor, fault: Optional[str]):
    """One AC scan of one image's component: blocks [N, 64] int64 in the
    scan's walk -> (histogram [256], the EOB run pending at its end)."""
    band = blocks[:, ss:se + 1]
    n, width = band.shape
    pos = torch.arange(width, device=blocks.device)
    if fault == "arithmetic_shift":
        t = (band >> al).abs()
    else:
        t = band.abs() >> al
    if ah == 0:
        coded = t != 0
        zero = ~coded
    else:
        coded = t == 1
        zero = t != 1 if fault == "corrections_as_zeros" else t == 0
    # The last coded position at or before each position, -1 for none.
    last = torch.cummax(torch.where(coded, pos, -1), dim=1).values
    prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], dim=1)
    zeros = torch.cumsum(zero.to(torch.int64), dim=1)  # zeros at or before each position
    zeros_at_prev = torch.where(prev >= 0, zeros.gather(1, prev.clamp(min=0)), 0)
    z = (zeros - zero.to(torch.int64) - zeros_at_prev)[coded]
    size = _bits(t[coded]) if ah == 0 else torch.ones_like(z)
    hist = _bincount((z % 16) << 4 | size)
    hist[0xF0] += int((z // 16).sum())
    codes = coded.any(dim=1)
    joins = last[:, -1] < width - 1
    runs, pending = _eob_runs(joins, codes, cuts, carry, fault)
    return hist + runs, pending


def _mcu_walk(plane: torch.Tensor, h: int, v: int) -> torch.Tensor:
    """[Hb, Wb, 64] -> [Hb Wb, 64] in the interleaved order of an (h, v) MCU."""
    hb, wb = plane.shape[:2]
    return plane.reshape(hb // v, v, wb // h, h, 64).permute(0, 2, 1, 3, 4).reshape(-1, 64)


def _grid(plane: torch.Tensor, sampling, c: int, size) -> torch.Tensor:
    """The component's own block grid, ceil(Xi/8) x ceil(Yi/8), from its
    padded plane (the host encoder's ``ceil(W / (8 Hmax / h))``)."""
    height, width = size
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    h, v = sampling[c]
    cols = -(-width // (8 * (hmax // h)))
    rows_ = -(-height // (8 * (vmax // v)))
    return plane[:rows_, :cols]


def image_histograms(planes: Sequence[torch.Tensor], sampling, size, script,
                     fault: Optional[str] = None, state=None):
    """One image's [R, 256] int64 histograms: ``planes`` each component's
    padded [Hb, Wb, 64] zig-zag plane. ``state`` (the DC predictors and the
    pending EOB runs carried from the image before) is used by the fault
    ``chains_not_restarted`` alone; returns (histograms, state)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    carried = fault == "chains_not_restarted" and state is not None
    dc_prev = dict(state[0]) if carried else {}
    runs_prev = dict(state[1]) if carried else {}
    device = planes[0].device
    out = torch.zeros((len(rows(script)), 256), dtype=torch.int64, device=device)
    pending_out, dc_out = {}, {}
    r = 0
    for i, (comps, ss, se, ah, al) in enumerate(script):
        if ss == 0:
            if ah != 0:
                continue
            for c in comps:
                h, v = sampling[c]
                dc = _mcu_walk(planes[c].to(torch.int64), h, v)[:, 0] >> al
                before = torch.cat([torch.tensor([dc_prev.get(c, 0)], device=device), dc[:-1]])
                out[r] = _bincount(_bits((dc - before).abs()))
                dc_out[c] = int(dc[-1]) if dc.numel() else dc_prev.get(c, 0)
                r += 1
            continue
        c = comps[0]
        grid = _grid(planes[c], sampling, c, size)
        cuts = torch.zeros(grid.shape[:2], dtype=torch.bool, device=device)
        if fault == "runs_not_stitched":
            cuts[:, ::SEGMENT] = True
        hist, pending = _ac_scan(grid.reshape(-1, 64).to(torch.int64), ss, se, ah, al,
                                 runs_prev.get(i, 0), cuts.reshape(-1), fault)
        if fault == "chains_not_restarted":
            pending_out[i] = pending
        else:
            hist = hist + _eob_symbols(torch.tensor([pending], device=device), fault)
        out[r] = hist
        r += 1
    return out, (dc_out, pending_out)


def histograms(planes: Sequence[torch.Tensor], size, script=SCRIPT_3,
               sampling=SAMPLING_420, fault: Optional[str] = None,
               count_dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """[B, R, 256] counts of ``count_dtype`` (int64; a narrower integer
    type wraps as a counter of that width would): the symbol histograms of
    each image of a batch, ``planes`` each component's [B, Hb, Wb, 64]
    zig-zag plane, ``size`` the images' (height, width). One image at a
    time, on the planes' device."""
    out, state = [], None
    for b in range(planes[0].shape[0]):
        hist, state = image_histograms([p[b] for p in planes], sampling, size, script,
                                       fault, state)
        out.append(hist)
    if fault == "chains_not_restarted" and out:  # the last image flushes every run
        for i, pending in state[1].items():
            r = next(k for k, (s, _) in enumerate(rows(script)) if s == i)
            out[-1][r] += _eob_symbols(torch.tensor([pending], device=out[-1].device), None)
    return torch.stack(out).to(count_dtype)


def bins_off(got: torch.Tensor, want: torch.Tensor) -> int:
    """The number of bins in which two histograms differ."""
    return int((got.to(torch.int64).cpu() != want.to(torch.int64).cpu()).sum())
