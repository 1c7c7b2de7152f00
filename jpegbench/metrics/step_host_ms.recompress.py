"""``step_host_ms.recompress``: the host's time in the program for one
step, the mean duration of the complete steps' ``full_step`` spans (opened
by the program around each call, on the profiler's host clock):
``dispatch_ms.recompress`` measured where it is spent rather than around
the call (``core/stages.py``)."""

from jpegbench.core.stages import step_host_ms


def read(ctx):
    return step_host_ms(ctx.trace)
