"""``k6_roofline.camera422``: K6's 4:2:2 instantiation (``ops.kernels.
color_round_trip`` -> ``csrc/color_round_trip.cu``, kernel
``color_round_trip_kernel<1>``, the MCU one block row high) against its
bound, over the trace's complete steps. A program without that
instantiation launches no such kernel, and the metric reads None there.

The work of a step: the colour round trip of every luma pixel. Its int32
luma sample and half of its two int32 chroma samples in (8 B), its uint8
RGB and its three uint8 YCbCr planes out (6 B): 14 B a luma pixel. The
integer operations of ``ops/color.py``'s formulas, a clamp counted as two:
per pixel the luma's clamp, an add and a clamp for each of R, G and B, and
three products, two adds and a shift for each of y, cb and cr (32); per
2 x 1 chroma cell (2 pixels) the two clamps, the two -128s and the 3 + 3 +
5 of ``cr_r``, ``cb_b`` and ``g_off`` (17)."""

from jpegbench.core.peaks import bound_s
from jpegbench.core.trace import roofline_pct

KERNEL = "color_round_trip_kernel<1>"
OPS_PER_PIXEL = 2 + 3 * 3 + 3 * 7
OPS_PER_CELL = 2 * 2 + 2 + 3 + 3 + 5


def step_bound_s(shape) -> float:
    pixels = shape["batch"] * shape["hb"] * shape["wb"] * 64
    return bound_s(14 * pixels, 0, pixels * OPS_PER_PIXEL + pixels // 2 * OPS_PER_CELL)


def read(ctx):
    return roofline_pct(ctx.trace, KERNEL, step_bound_s(ctx.shape))
