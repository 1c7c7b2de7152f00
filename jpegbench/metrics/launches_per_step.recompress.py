"""``launches_per_step.recompress``: the device records (kernels, copies,
fills) launched under the program's ``full_step`` span and its stages in
one complete step, as the mean over the complete steps. Each launch costs
the host a dispatch; it is what a fused kernel cuts. Read from the device
trace (``core/stages.py``)."""

from jpegbench.core.stages import launches_per_step


def read(ctx):
    return launches_per_step(ctx.trace)
