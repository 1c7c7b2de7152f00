"""jpx-encode: PNG/image -> baseline JPEG.

CLI parity with the reference JpegEncode app
(yigolden/JpegLibrary/apps/JpegEncode/Program.cs:12-61, EncodeAction.cs:17-72):
RGB -> YCbCr (fixed-point), 4:2:0 (or 4:4:4), quality-scaled Annex-K
quantization tables, standard or optimized Huffman coding.

The port's copy of ``jpeglibrary_tpu/cli/encode.py``, over the port's
host layers (``jpeglibrary_tpu_torch.host``), which run on numpy as the
JAX package's CLIs do. Run as ``python -m jpeglibrary_tpu_torch.cli.encode``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="jpx-encode", description="Encode image to JPEG.")
    parser.add_argument("source", help="input image file (PNG, ...)")
    parser.add_argument("output", help="output JPEG file")
    parser.add_argument("--quality", type=int, default=75, help="quality 1-100 (default 75)")
    parser.add_argument(
        "--optimize-coding", action="store_true",
        help="build image-specific Huffman tables (2-pass)",
    )
    parser.add_argument(
        "--most-optimal", action="store_true",
        help="use package-merge optimal length-limited tables",
    )
    parser.add_argument("--subsampling", choices=["420", "444"], default="420")
    parser.add_argument(
        "--restart-interval", type=int, default=0, metavar="MCUS",
        help="emit DRI + RSTn every N MCUs (enables restart-parallel decode)",
    )
    args = parser.parse_args(argv)

    import numpy as np
    from PIL import Image

    from ..host.models.encoder import encode_rgb

    with Image.open(args.source) as im:
        rgb = np.asarray(im.convert("RGB"))
    blob = encode_rgb(
        rgb,
        args.quality,
        subsampling=args.subsampling,
        optimize_coding=args.optimize_coding,
        most_optimal_coding=args.most_optimal,
        restart_interval=args.restart_interval,
    )
    open(args.output, "wb").write(blob)
    print(f"{args.source}: {rgb.shape[1]}x{rgb.shape[0]} -> {args.output} ({len(blob)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
