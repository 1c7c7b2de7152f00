"""``k7_roofline.prog``: K7 (``ops.kernels.progressive_histograms`` ->
``csrc/progressive_hist.cu``, kernels ``progressive_hist_kernel``, one
launch a component, and ``progressive_eobrun_kernel``, the EOB runs'
stitch) against its bound, over the trace's complete steps. A program
without K7 launches no such kernel, and the metric reads None there.

The work of a step: the per-image symbol statistics of libjpeg's 10-scan
script over every component. One read of the int16 zig-zag blocks (the
luma and both quarter-size chroma planes, 128 B a block) and the write of
the [B, 11, 256] int32 histograms, at the memory rate. The bound is the
same whatever implements K7: a kernel that reads the blocks once a scan
reads low against it."""

from jpegbench.core.trace import roofline_pct
from jpegbench.entries.transcode_progressive import step_bound_s

KERNEL = "progressive_"  # progressive_hist_kernel and progressive_eobrun_kernel


def read(ctx):
    return roofline_pct(ctx.trace, KERNEL, step_bound_s(ctx.shape))
