"""``k2_roofline.recompress``: K2 (``ops.kernels.fdct_quantize`` ->
``csrc/fdct_quant.cu``, kernel ``fdct_quant_kernel``) against its bound,
over the trace's complete steps.

The work of a step: the luma's and each chroma's re-encode transform.
The full-resolution uint8 plane and the int32 table in, int16 zig-zag
coefficients out (the chroma boxed 2 x 2 on the way); the 64 x 64
product per block; a box add per sample, a level shift and a divide per
coefficient."""

from jpegbench.core.peaks import bound_s
from jpegbench.core.trace import roofline_pct


def step_bound_s(shape) -> float:
    b, hb, wb = shape["batch"], shape["hb"], shape["wb"]
    samples = b * hb * wb * 64  # every component's plane is at full resolution
    total = 0.0
    for n in (b * hb * wb, b * (hb // 2) * (wb // 2), b * (hb // 2) * (wb // 2)):
        total += bound_s(samples + 64 * 4 + n * 64 * 2, n * 2 * 64 * 64, samples + n * 64 * 2)
    return total


def read(ctx):
    return roofline_pct(ctx.trace, "fdct_quant_kernel", step_bound_s(ctx.shape))
