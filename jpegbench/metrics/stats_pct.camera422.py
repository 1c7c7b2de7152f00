"""``stats_pct.camera422``: ``stats_pct.recompress`` in the cell of 4:2:2
frames: the share of the complete steps' kernel time launched under the
program's ``full_step.stats`` span (K5's two launches, the luma in its
(2, 1) walk, the histograms' zero fills and their stack). It is that
metric's reader, loaded as it stands; a run of another entry than
``recompress_422`` reads None."""

from jpegbench.core.spec import metric_reader

_read = metric_reader("stats_pct.recompress")


def read(ctx):
    if ctx.workload is None or ctx.workload.traffic.get("entry") != "recompress_422":
        return None
    return _read(ctx)
