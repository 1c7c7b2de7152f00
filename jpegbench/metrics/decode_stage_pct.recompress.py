"""``decode_stage_pct.recompress``: the share of the complete steps' kernel
time launched under the program's ``full_step.decode`` span: K1's three
launches, ``blocks_to_plane``, ``upsample_duplicate`` and
``clamp_to_uint8``. Read from the device trace, each kernel tied to the
innermost program span around its launch (``core/stages.py``)."""

from jpegbench.core.stages import stage_pct


def read(ctx):
    return stage_pct(ctx.trace, ("full_step.decode",))
