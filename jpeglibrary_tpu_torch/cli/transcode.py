"""jpx-transcode: lossless re-encoding between entropy codings.

Beyond the reference app set (its only transcoder is JpegOptimize,
baseline input only): any decodable JPEG re-encodes as optimized /
optimal Huffman, progressive, arithmetic or arithmetic-progressive
while preserving the quantized coefficients exactly; lossless inputs
re-encode predictively with fresh optimal tables.

The port's copy of ``jpeglibrary_tpu/cli/transcode.py``, over the port's
host layers (``jpeglibrary_tpu_torch.host``), which run on numpy as the
JAX package's CLIs do. Run as ``python -m jpeglibrary_tpu_torch.cli.transcode``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="jpx-transcode",
        description="Losslessly re-encode a JPEG with a different entropy coding.",
    )
    parser.add_argument("source", help="input JPEG file")
    parser.add_argument("output", help="output JPEG file")
    parser.add_argument(
        "--mode",
        default="optimized",
        choices=[
            "optimized", "optimal", "progressive",
            "arithmetic", "arithmetic-progressive",
        ],
        help="target entropy coding (DCT inputs; default: optimized)",
    )
    parser.add_argument(
        "--predictor", type=int, default=None, choices=range(1, 8),
        help="lossless inputs: predictor 1-7 (default: smallest output)",
    )
    parser.add_argument(
        "--restart-interval", type=int, default=0,
        help="emit DRI/RSTn seams every N MCUs where supported",
    )
    parser.add_argument(
        "--transform", default=None,
        choices=[
            "transpose", "fliph", "flipv",
            "rot90", "rot180", "rot270", "transverse",
        ],
        help="lossless geometric transform in the coefficient domain "
             "(jpegtran-class rotate/flip/transpose)",
    )
    parser.add_argument(
        "--trim", action="store_true",
        help="with --transform: drop a non-iMCU-aligned edge instead "
             "of refusing (jpegtran -trim)",
    )
    parser.add_argument(
        "--crop", nargs=4, type=int, metavar=("X", "Y", "W", "H"),
        default=None,
        help="lossless crop to the region at X,Y of size WxH "
             "(origin snapped down to the iMCU grid, jpegtran -crop)",
    )
    args = parser.parse_args(argv)

    from ..host.models.transcode import crop, transcode, transform

    data = open(args.source, "rb").read()
    if args.crop is not None:
        x, y, w, h = args.crop
        out = crop(
            data, x, y, w, h, snap=True, mode=args.mode,
            restart_interval=args.restart_interval,
        )
    elif args.transform is not None:
        out = transform(
            data, args.transform, mode=args.mode,
            restart_interval=args.restart_interval, trim=args.trim,
        )
    else:
        out = transcode(
            data, args.mode,
            restart_interval=args.restart_interval,
            predictor=args.predictor,
        )
    open(args.output, "wb").write(out)
    delta = len(data) - len(out)
    print(
        f"{args.source}: {len(data)} -> {len(out)} bytes "
        f"({'saved ' + str(delta) if delta >= 0 else 'grew ' + str(-delta)})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
