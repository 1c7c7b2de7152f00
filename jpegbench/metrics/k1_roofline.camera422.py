"""``k1_roofline.camera422``: K1 (``ops.kernels.dequantize_idct_shift`` ->
``csrc/dequant_idct.cu``, kernel ``dequant_idct_kernel``) against its bound
in a 4:2:2 step, over the trace's complete steps.

The work of a step: the decode transform of the luma [B, Hb, Wb] and of
each chroma [B, Hb, Wb/2] block planes. Per block, int16 zig-zag
coefficients and the int32 table in, int32 samples out; the 64 x 64
product; a dequantising multiply per coefficient and a rounding add per
sample."""

from jpegbench.core.peaks import bound_s
from jpegbench.core.trace import roofline_pct

KERNEL = "dequant_idct_kernel"


def step_bound_s(shape) -> float:
    b, hb, wb = shape["batch"], shape["hb"], shape["wb"]
    total = 0.0
    for n in (b * hb * wb, b * hb * (wb // 2), b * hb * (wb // 2)):
        total += bound_s(n * 64 * 2 + 64 * 4 + n * 64 * 4, n * 2 * 64 * 64, n * 64 * 2)
    return total


def read(ctx):
    return roofline_pct(ctx.trace, KERNEL, step_bound_s(ctx.shape))
