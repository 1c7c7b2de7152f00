"""``step_roofline.prog``: the whole count pass of the progressive
transcode against its bound, over the window on the host clock, as
``step_roofline.recompress`` reads its step: steps x the step's bound over
the window. A run that opens no ``progressive_step`` span reads None.

The step's bound is its interface's bytes at the memory rate: the int16
coefficients in (the luma and both quarter-size chroma planes) and the
[B, 11, 256] int32 histograms out. It bounds every kernel the step runs,
so it stays when a kernel leaves the path."""

from jpegbench.core.step_view import opens
from jpegbench.entries.transcode_progressive import step_bound_s


def read(ctx):
    w = ctx.window
    if not opens(ctx.trace, "progressive_step") or not w.steps or w.seconds <= 0.0:
        return None
    return 100.0 * w.steps * step_bound_s(ctx.shape) / w.seconds
