"""``encode_stage_pct.camera422``: ``encode_stage_pct.recompress`` in the
cell of 4:2:2 frames: the share of the complete steps' kernel time
launched under the program's ``full_step.fdct`` span (K2's three
launches, the chroma's two at the 2 x 1 box). It is that metric's
reader, loaded as it stands; a run of another entry than
``recompress_422`` reads None."""

from jpegbench.core.spec import metric_reader

_read = metric_reader("encode_stage_pct.recompress")


def read(ctx):
    if ctx.workload is None or ctx.workload.traffic.get("entry") != "recompress_422":
        return None
    return _read(ctx)
