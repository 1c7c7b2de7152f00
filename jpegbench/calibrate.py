"""The readings that the limits of ``correct`` are set from, at a cell's
own sizes, in one process:

    python3 jpegbench/calibrate.py --workload <name> --seeds 1 2 3 --control 1 2 3

For each of ``--seeds``, the numbers that the program's outputs give
against the reference, on one step of each pool batch (the timed entry at
the timed sizes). For each of ``--control``, the numbers that the control
gives on the same steps: the reference computed one precision below the
configuration's, TF32 for its float32, put in the program's place. Prints
one JSON line a seed and side; the limits lie between the program's
largest readings and the control's smallest. Needs the card, as a run
does. The benchmark's runs never run the control.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def scan_bits_per_pixel(y, cb, cr, pixels: int) -> float:
    """Bits a source pixel of the baseline scan that coefficient planes
    stand for, each histogram coded at its entropy (optimised tables) with
    its magnitude bits: the density of the traffic, against the
    configuration's source files."""
    import torch

    from jpegbench.reference.recompress import histograms, mcu_order

    size = torch.arange(256, device=y.device)
    bits = 0.0
    for chains in (mcu_order(y, 2, 2), torch.cat([mcu_order(cb, 1, 1), mcu_order(cr, 1, 1)])):
        dc, ac = histograms(chains)
        for hist, extra in ((dc, size), (ac, size & 15)):
            h = hist[hist > 0].to(torch.float64)
            bits += float(-(h * torch.log2(h / h.sum())).sum() + (hist * extra).sum())
    return bits / (y.shape[0] * pixels)


def readings(workload: str, seed: int, control: bool, device=None, root=None):
    """The worst of each number over one step of each pool batch, and the
    pool's ``scan_bits_per_pixel``."""
    from jpegbench.core import harness, spec
    from jpegbench.core.trace import Tracer
    from jpegbench.reference import recompress as reference

    w = spec.load(workload, root or spec.ROOT)
    device = device or harness.card(w.chips)
    run = w.entry().Run(w, seed, device, Tracer(False))
    run.setup()
    worst = {}
    pixels = run.shape["width"] * run.shape["height"]
    density = [scan_bits_per_pixel(*batch, pixels) for batch in run.pool]
    for i, batch in enumerate(run.pool):
        inputs = (*batch, run.qy, run.qc)
        outputs = reference.step(*inputs, precision="tf32") if control else run.step(i)
        for k, v in reference.judge(inputs, outputs).items():
            worst[k] = max(worst.get(k, v), v)
    return {**worst, "scan_bits_per_pixel": sum(density) / len(density)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    seen = {"program": [], "control": []}
    for side, seeds in (("program", args.seeds), ("control", args.control)):
        for seed in seeds:
            t = time.perf_counter()
            numbers = readings(args.workload, seed, side == "control")
            seen[side].append(numbers)
            print(json.dumps({"workload": args.workload, "side": side, "seed": seed,
                              "seconds": time.perf_counter() - t, **numbers}), flush=True)
    # The two readings that each limit lies between.
    names = sorted({k for numbers in seen["program"] + seen["control"] for k in numbers})
    print(json.dumps({"workload": args.workload, "summary": {
        k: {"program_max": max((n[k] for n in seen["program"]), default=None),
            "control_min": min((n[k] for n in seen["control"]), default=None)} for k in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
