"""``step_host_ms.prog``: the host's time in the program for one count
pass of the progressive transcode, the mean duration of the complete
steps' ``progressive_step`` spans (opened by the program around each call,
on the profiler's host clock). A program without ``progressive_step``
opens no such span and the metric reads None."""

from jpegbench.core.stages import step_host_ms
from jpegbench.core.step_view import as_full_step


def read(ctx):
    return step_host_ms(as_full_step(ctx.trace, "progressive_step"))
