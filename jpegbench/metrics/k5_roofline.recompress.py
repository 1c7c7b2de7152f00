"""``k5_roofline.recompress``: K5 (``ops.kernels.symbol_histograms`` ->
``csrc/symbol_hist.cu``, kernel ``symbol_hist_kernel``) against its
bound, over the trace's complete steps.

The work of a step: the symbol statistics of the requantised luma, then
of both chroma planes. The int16 zig-zag blocks in, the [2, 256] int32
histograms out; a non-zero test per coefficient."""

from jpegbench.core.peaks import bound_s
from jpegbench.core.trace import roofline_pct


def step_bound_s(shape) -> float:
    b, hb, wb = shape["batch"], shape["hb"], shape["wb"]
    luma, chroma = b * hb * wb * 64, 2 * b * (hb // 2) * (wb // 2) * 64
    hists = 2 * 256 * 4
    return bound_s(luma * 2 + hists, 0, luma) + bound_s(chroma * 2 + hists, 0, chroma)


def read(ctx):
    return roofline_pct(ctx.trace, "symbol_hist_kernel", step_bound_s(ctx.shape))
