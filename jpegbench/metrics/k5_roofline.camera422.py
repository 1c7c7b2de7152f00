"""``k5_roofline.camera422``: K5 (``ops.kernels.symbol_histograms`` ->
``csrc/symbol_hist.cu``, kernel ``symbol_hist_kernel``) against its bound
in a 4:2:2 step, over the trace's complete steps.

The work of a step: the symbol statistics of the requantised luma [B, Hb,
Wb] in its (2, 1) MCU walk, then of both chroma planes [B, Hb, Wb/2]. The
int16 zig-zag blocks in, the [2, 256] int32 histograms out; a non-zero
test per coefficient."""

from jpegbench.core.peaks import bound_s
from jpegbench.core.trace import roofline_pct

KERNEL = "symbol_hist_kernel"


def step_bound_s(shape) -> float:
    b, hb, wb = shape["batch"], shape["hb"], shape["wb"]
    luma, chroma = b * hb * wb * 64, 2 * b * hb * (wb // 2) * 64
    hists = 2 * 256 * 4
    return bound_s(luma * 2 + hists, 0, luma) + bound_s(chroma * 2 + hists, 0, chroma)


def read(ctx):
    return roofline_pct(ctx.trace, KERNEL, step_bound_s(ctx.shape))
