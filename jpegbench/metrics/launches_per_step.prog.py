"""``launches_per_step.prog``: the device records (kernels, copies, fills)
launched under the program's ``progressive_step`` span and its
``progressive_step.eobrun`` span in one complete step, as the mean over
the complete steps: K7's pass a component, its stitch and the
histograms' fill. Read from the device trace (``core/stages.py``)."""

from jpegbench.core.stages import launches_per_step
from jpegbench.core.step_view import as_full_step


def read(ctx):
    return launches_per_step(as_full_step(ctx.trace, "progressive_step"))
