"""jpx-decode: JPEG -> PNG.

CLI parity with the reference JpegDecode app
(yigolden/JpegLibrary/apps/JpegDecode/Program.cs:12-47, DecodeAction.cs:17-99):
decode to YCbCr samples, convert to RGB with the fixed-point converter
(grayscale fills Cb=Cr=128), write PNG.

The port's copy of ``jpeglibrary_tpu/cli/decode.py``, over the port's
host layers (``jpeglibrary_tpu_torch.host``), which run on numpy as the
JAX package's CLIs do. Run as ``python -m jpeglibrary_tpu_torch.cli.decode``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="jpx-decode", description="Decode JPEG to PNG.")
    parser.add_argument("source", help="input JPEG file")
    parser.add_argument("output", help="output PNG file")
    parser.add_argument(
        "--metrics", action="store_true", help="print per-stage timing counters"
    )
    parser.add_argument(
        "--fancy-upsampling",
        action="store_true",
        help="triangular chroma upsampling (libjpeg's default filter) "
        "instead of the reference's duplication",
    )
    parser.add_argument(
        "--cmyk",
        action="store_true",
        help="write 4-component streams as CMYK ink values (TIFF/PNG-"
        "compatible array) instead of the RGB view",
    )
    parser.add_argument(
        "--region",
        metavar="X,Y,W,H",
        help="decode only this pixel rectangle (restart-span skipping "
        "on baseline streams with DRI: cost scales with the region, "
        "not the image)",
    )
    args = parser.parse_args(argv)

    from PIL import Image

    import jpeglibrary_tpu_torch as jt
    from ..host.utils import metrics

    if args.metrics:
        metrics.enable()
    data = open(args.source, "rb").read()
    if args.region:
        try:
            x, y, w, h = (int(v) for v in args.region.split(","))
        except ValueError:
            parser.error("--region expects X,Y,W,H integers")
        upsample = "fancy" if args.fancy_upsampling else "duplicate"
        tile = jt.decode_region(data, x, y, w, h, upsample=upsample)
        if tile.shape[-1] == 4:
            Image.fromarray(tile, mode="CMYK").save(args.output)
        else:
            Image.fromarray(tile, mode="RGB").save(args.output)
        print(f"{args.source}: region {w}x{h}+{x}+{y} -> {args.output}")
        if args.metrics:
            print(metrics.report())
        return 0
    if args.cmyk:
        result = jt.decode(data)
        Image.fromarray(result.to_cmyk8(), mode="CMYK").save(args.output)
        size = (result.width, result.height)
    else:
        upsample = "fancy" if args.fancy_upsampling else "duplicate"
        # One-call fused scan + RGB transform where eligible; bit-exact
        # staged fallback otherwise.
        rgb = jt.decode_rgb8(data, upsample=upsample)
        Image.fromarray(rgb, mode="RGB").save(args.output)
        size = (rgb.shape[1], rgb.shape[0])
    print(f"{args.source}: {size[0]}x{size[1]} -> {args.output}")
    if args.metrics:
        print(metrics.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
