"""The readings that the limits of ``correct`` are set from in a cell of the
``recompress_422`` entry, at the cell's own sizes, in one process:

    python3 jpegbench/calibrate_422.py --workload recompress_24mp_422_b4 --seeds 1 2 3 --control 4 5 6

``jpegbench/calibrate.py`` for 4:2:2 batches, through its ``main()``: for
each of ``--seeds``, the numbers that the program's outputs give against
``reference/recompress_422.py`` on one step of each pool batch; for each of
``--control``, the numbers that the control gives on the same steps (the
reference with its products in TF32, one precision below the
configuration's float32, put in the program's place). Prints one JSON line
a seed and side, then the program's largest and the control's smallest
reading of each number: each limit lies between them. Each line also
gives the pool's density: the scan's bits a pixel at its entropy and the
non-zero AC coefficients a block of the luma and of the chroma. Needs the
card, as a run does.
"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def scan_bits_per_pixel(y, cb, cr, pixels: int) -> float:
    """Bits a source pixel of the baseline scan that 4:2:2 coefficient
    planes stand for, each histogram coded at its entropy (optimised tables)
    with its magnitude bits: the luma in its (2, 1) MCU walk, the chroma in
    raster chains."""
    import torch

    from jpegbench.reference.recompress_422 import LUMA_MCU, histograms, mcu_order

    size = torch.arange(256, device=y.device)
    bits = 0.0
    for chains in (mcu_order(y, *LUMA_MCU),
                   torch.cat([mcu_order(cb, 1, 1), mcu_order(cr, 1, 1)])):
        dc, ac = histograms(chains)
        for hist, extra in ((dc, size), (ac, size & 15)):
            h = hist[hist > 0].to(torch.float64)
            bits += float(-(h * torch.log2(h / h.sum())).sum() + (hist * extra).sum())
    return bits / (y.shape[0] * pixels)


def _nonzero_ac(*planes) -> float:
    """Non-zero AC coefficients a block of zig-zag planes [B, Hb, Wb, 64]."""
    return (sum(int((p[..., 1:] != 0).sum()) for p in planes)
            / sum(p[..., 0].numel() for p in planes))


def readings(workload: str, seed: int, control: bool, device=None, root=None):
    """The worst of each number over one step of each pool batch, and the
    pool's ``scan_bits_per_pixel`` and non-zero AC a block."""
    from jpegbench.core import harness, spec
    from jpegbench.core.trace import Tracer
    from jpegbench.reference import recompress_422 as reference

    w = spec.load(workload, root or spec.ROOT)
    device = device or harness.card(w.chips)
    run = w.entry().Run(w, seed, device, Tracer(False))
    run.setup()
    worst = {}
    pixels = run.shape["width"] * run.shape["height"]
    for i, batch in enumerate(run.pool):
        inputs = (*batch, run.qy, run.qc)
        outputs = reference.step(*inputs, precision="tf32") if control else run.step(i)
        for k, v in reference.judge(inputs, outputs).items():
            worst[k] = max(worst.get(k, v), v)
    n = len(run.pool)
    return {**worst,
            "scan_bits_per_pixel": sum(scan_bits_per_pixel(*b, pixels) for b in run.pool) / n,
            "luma_nonzero_ac": sum(_nonzero_ac(b[0]) for b in run.pool) / n,
            "chroma_nonzero_ac": sum(_nonzero_ac(*b[1:]) for b in run.pool) / n}


def main(argv=None) -> int:
    """``calibrate.py``'s ``main()`` with this module's :func:`readings`."""
    from jpegbench import calibrate

    calibrate.readings = readings
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
