"""``step_host_ms.camera422``: ``step_host_ms.recompress`` in the cell of
4:2:2 frames: the host's time in the program for one step, the mean
duration of the complete steps' ``full_step`` spans (on the profiler's
host clock). It is that metric's reader, loaded as it stands; a run of
another entry than ``recompress_422`` reads None."""

from jpegbench.core.spec import metric_reader

_read = metric_reader("step_host_ms.recompress")


def read(ctx):
    if ctx.workload is None or ctx.workload.traffic.get("entry") != "recompress_422":
        return None
    return _read(ctx)
