"""jpx-debugdump: golden-fixture generator.

CLI parity with the reference JpegDebugDump app
(yigolden/JpegLibrary/apps/JpegDebugDump/Program.cs:12-50,
DebugDumpAction.cs:44-104): decode to 16-bit extended samples, split
into `<out>.high.png` (high bytes) and `<out>.low-diff.png` (low bytes
XOR-predicted by the high byte).

The port's copy of ``jpeglibrary_tpu/cli/debugdump.py``, over the port's
host layers (``jpeglibrary_tpu_torch.host``), which run on numpy as the
JAX package's CLIs do. Run as ``python -m jpeglibrary_tpu_torch.cli.debugdump``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="jpx-debugdump", description="Dump 16-bit decode fixtures."
    )
    parser.add_argument("source", help="input JPEG file")
    parser.add_argument(
        "--output-prefix", default=None,
        help="output prefix (default: the source path)",
    )
    args = parser.parse_args(argv)

    from PIL import Image

    import jpeglibrary_tpu_torch as jt
    from ..host.utils.fixtures import split_to_fixture

    prefix = args.output_prefix or args.source
    data = open(args.source, "rb").read()
    result = jt.decode(data)
    buffer16 = result.to_uint16_extended()
    high, low_diff = split_to_fixture(buffer16)
    Image.fromarray(high, mode="RGBA").save(prefix + ".high.png")
    Image.fromarray(low_diff, mode="RGBA").save(prefix + ".low-diff.png")
    print(f"{args.source}: wrote {prefix}.high.png and {prefix}.low-diff.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
