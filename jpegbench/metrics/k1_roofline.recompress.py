"""``k1_roofline.recompress``: K1 (``ops.kernels.dequantize_idct_shift`` ->
``csrc/dequant_idct.cu``, kernel ``dequant_idct_kernel``) against its
bound, over the trace's complete steps.

The work of a step: the luma's and each chroma's decode transform. Per
block, int16 zig-zag coefficients and the int32 table in, int32 samples
out; the 64 x 64 product; a dequantising multiply per coefficient and a
rounding add per sample."""

from jpegbench.core.peaks import bound_s
from jpegbench.core.trace import roofline_pct


def step_bound_s(shape) -> float:
    b, hb, wb = shape["batch"], shape["hb"], shape["wb"]
    total = 0.0
    for n in (b * hb * wb, b * (hb // 2) * (wb // 2), b * (hb // 2) * (wb // 2)):
        total += bound_s(n * 64 * 2 + 64 * 4 + n * 64 * 4, n * 2 * 64 * 64, n * 64 * 2)
    return total


def read(ctx):
    return roofline_pct(ctx.trace, "dequant_idct_kernel", step_bound_s(ctx.shape))
