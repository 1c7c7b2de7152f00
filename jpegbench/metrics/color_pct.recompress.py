"""``color_pct.recompress``: the share of the complete steps' kernel time
launched under the program's ``full_step.to_rgb`` and
``full_step.to_ycbcr`` spans: ``color.ycbcr_to_rgb`` with the RGB stack,
and ``color.rgb_to_ycbcr`` (ROADMAP §2 item 4's target). Read from the
device trace, each kernel tied to the innermost program span around its
launch (``core/stages.py``)."""

from jpegbench.core.stages import stage_pct


def read(ctx):
    return stage_pct(ctx.trace, ("full_step.to_rgb", "full_step.to_ycbcr"))
