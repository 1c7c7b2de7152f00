"""``launches_per_step.camera422``: the device records (kernels, copies,
fills) launched under the program's ``full_step`` span and its stages in
one complete 4:2:2 step, as the mean over the complete steps: K1 x 3, K6,
K2 x 3, K5 x 2 and the histograms' fills and stack. Read from the device
trace (``core/stages.py``)."""

from jpegbench.core.stages import launches_per_step


def read(ctx):
    return launches_per_step(ctx.trace)
