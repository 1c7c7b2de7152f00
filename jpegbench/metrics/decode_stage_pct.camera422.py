"""``decode_stage_pct.camera422``: ``decode_stage_pct.recompress`` in the
cell of 4:2:2 frames: the share of the complete steps' kernel time
launched under the program's ``full_step.decode`` span (K1's three
launches). It is that metric's reader, loaded as it stands; a run of
another entry than ``recompress_422`` reads None."""

from jpegbench.core.spec import metric_reader

_read = metric_reader("decode_stage_pct.recompress")


def read(ctx):
    if ctx.workload is None or ctx.workload.traffic.get("entry") != "recompress_422":
        return None
    return _read(ctx)
