"""The readings that the limit of ``correct`` is set from in a cell of the
``transcode_progressive`` entry, at the cell's own sizes, in one process:

    python3 jpegbench/calibrate_prog.py --workload transcode_prog_12mp_b32 --seeds 1 2 3 --control 4 5 6

``jpegbench/calibrate.py`` for the progressive transcode's count pass,
through its ``main()``: for each of ``--seeds``, ``hist_bins_off`` of the
program's step on each pool batch against ``reference/
transcode_progressive.py``; for each of ``--control``, the same of the
control, the reference counting in int16 (the nearest integer width below
the program's int32 counters, wrapping as such a counter would). Both sides
also read each of the reference's planted faults (``fault.<name>``), put in
the program's place. Prints one JSON line a seed and side, then the
program's largest and the control's smallest reading of each number. Each
line also gives the pool's density: the progressive file's bits a pixel
with each image's four tables coded at their entropy, the non-zero AC
coefficients a block of the luma and of the chroma, and the longest EOB
run of any scan. Needs the card, as a run does.
"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _entropy_bits(hist) -> float:
    """Bits of the symbols of a histogram coded at its entropy."""
    import torch

    h = hist[hist > 0].to(torch.float64)
    return float(-(h * torch.log2(h / h.sum())).sum()) if h.numel() else 0.0


def file_bits_per_pixel(planes, hists, pixels: int) -> float:
    """Bits a source pixel of the progressive files of a batch: per image,
    its DC and AC tables of each class (luma, chroma) at their entropy, the
    symbols' appended bits (a DC or first AC symbol's size, an EOB run's r
    bits, a refinement's sign bit), the refinements' correction bits and
    the DC refinement's one bit a block."""
    import torch

    from jpegbench.reference.transcode_progressive import SCRIPT_3, rows

    row_of = rows(SCRIPT_3)
    symbol = torch.arange(256, device=hists.device)
    low, high = symbol & 15, symbol >> 4
    bits = 0.0
    for b in range(hists.shape[0]):
        h = hists[b].to(torch.int64)
        for dc in (True, False):
            for chroma in (False, True):
                picked = [r for r, (scan, c) in enumerate(row_of)
                          if (SCRIPT_3[scan][1] == 0) == dc and (c > 0) == chroma]
                if picked:
                    bits += _entropy_bits(h[picked].sum(0))
        for r, (scan, _) in enumerate(row_of):
            _, ss, _, ah, _ = SCRIPT_3[scan]
            if ss == 0:
                extra = symbol
            elif ah == 0:
                extra = torch.where(low > 0, low, torch.where(high < 15, high, 0))
            else:
                extra = torch.where(low > 0, 1, torch.where(high < 15, high, 0))
            bits += float((h[r] * extra).sum())
    for comps, ss, se, ah, al in SCRIPT_3:
        for c in comps:
            if ss == 0 and ah != 0:
                bits += planes[c][..., 0].numel()
            elif ss > 0 and ah != 0:
                bits += float(((planes[c][..., ss:se + 1].abs().to(torch.int32) >> al) > 1).sum())
    return bits / (hists.shape[0] * pixels)


def _nonzero_ac(*planes) -> float:
    return (sum(int((p[..., 1:] != 0).sum()) for p in planes)
            / sum(p[..., 0].numel() for p in planes))


def longest_run(planes, size) -> int:
    """The longest EOB run (blocks) of any AC scan of any image."""
    import torch

    from jpegbench.reference import transcode_progressive as reference

    longest = 0
    for b in range(planes[0].shape[0]):
        for comps, ss, se, ah, al in reference.SCRIPT_3:
            if ss == 0:
                continue
            grid = reference._grid(planes[comps[0]][b], reference.SAMPLING_420, comps[0], size)
            t = grid.reshape(-1, 64)[:, ss:se + 1].abs().to(torch.int32) >> al
            coded = t != 0 if ah == 0 else t == 1
            pos = torch.arange(t.shape[1], device=t.device)
            last = torch.where(coded, pos, -1).max(1).values
            joins = (last < t.shape[1] - 1).to(torch.int64)
            codes = coded.any(1)
            # joining blocks since the last coding block, at each block
            idx = torch.arange(joins.numel(), device=t.device)
            start = torch.cummax(torch.where(codes, idx, 0), 0).values
            total = torch.cumsum(joins, 0)
            run = total - torch.cat([torch.zeros(1, dtype=torch.int64, device=t.device),
                                     total[:-1]])[start]
            longest = max(longest, int(run.max()) if run.numel() else 0)
    return longest


def readings(workload: str, seed: int, control: bool, device=None, root=None):
    """The worst of each number over one step of each pool batch, and the
    pool's density."""
    import torch

    from jpegbench.core import harness, spec
    from jpegbench.core.trace import Tracer
    from jpegbench.entries.transcode_progressive import judge
    from jpegbench.reference import transcode_progressive as reference

    w = spec.load(workload, root or spec.ROOT)
    device = device or harness.card(w.chips)
    run = w.entry().Run(w, seed, device, Tracer(False))
    run.setup()
    worst = {}

    def keep(numbers, prefix=""):
        for k, v in numbers.items():
            worst[prefix + k] = max(worst.get(prefix + k, v), v)

    density = {"file_bits_per_pixel": 0.0, "luma_nonzero_ac": 0.0, "chroma_nonzero_ac": 0.0,
               "longest_eob_run": 0}
    pixels = run.shape["width"] * run.shape["height"]
    for i, batch in enumerate(run.pool):
        if control:
            hists = reference.histograms(batch, run.size, count_dtype=torch.int16)
        else:
            hists = run.step(i)
        keep(judge(batch, hists, run.size))
        # What does not depend on the side (``calibrate.main`` reads the same
        # names on both): the faults and the pool's density.
        for fault in reference.FAULTS:
            keep(judge(batch, reference.histograms(batch, run.size, fault=fault), run.size),
                 f"fault.{fault}.")
        density["file_bits_per_pixel"] += file_bits_per_pixel(
            batch, reference.histograms(batch, run.size), pixels) / len(run.pool)
        density["luma_nonzero_ac"] += _nonzero_ac(batch[0]) / len(run.pool)
        density["chroma_nonzero_ac"] += _nonzero_ac(*batch[1:]) / len(run.pool)
        density["longest_eob_run"] = max(density["longest_eob_run"],
                                         longest_run(batch, run.size))
    return {**worst, **density}


def main(argv=None) -> int:
    """``calibrate.py``'s ``main()`` with this module's :func:`readings`."""
    from jpegbench import calibrate

    calibrate.readings = readings
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
