"""jpx-optimize: lossless Huffman re-optimization of baseline JPEG.

CLI parity with the reference JpegOptimize app
(yigolden/JpegLibrary/apps/JpegOptimize/Program.cs:12-47, OptimizeAction.cs:20-27).

The port's copy of ``jpeglibrary_tpu/cli/optimize.py``, over the port's
host layers (``jpeglibrary_tpu_torch.host``), which run on numpy as the
JAX package's CLIs do. Run as ``python -m jpeglibrary_tpu_torch.cli.optimize``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="jpx-optimize", description="Optimize JPEG Huffman coding losslessly."
    )
    parser.add_argument("source", help="input JPEG file")
    parser.add_argument("output", help="output JPEG file")
    parser.add_argument(
        "--no-strip", action="store_true", help="keep APPn/COM metadata segments"
    )
    parser.add_argument(
        "--standard-tables", action="store_true",
        help="use the Annex-K table build instead of package-merge",
    )
    args = parser.parse_args(argv)

    from ..host.models.optimizer import optimize

    data = open(args.source, "rb").read()
    out = optimize(
        data, strip=not args.no_strip, most_optimal_coding=not args.standard_tables
    )
    open(args.output, "wb").write(out)
    saved = len(data) - len(out)
    print(f"{args.source}: {len(data)} -> {len(out)} bytes ({saved} saved)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
