"""``device_idle_pct.camera422``: ``device_idle_pct.recompress`` in the
cell of 4:2:2 frames: the share of the traced window, from the first
dispatch to the end of the closing synchronise, in which no kernel, copy
or fill ran on the device. It is that metric's reader, loaded as it
stands, so that both read the same union of device intervals; a run of
another entry than ``recompress_422`` reads None."""

from jpegbench.core.spec import metric_reader

_read = metric_reader("device_idle_pct.recompress")


def read(ctx):
    if ctx.workload is None or ctx.workload.traffic.get("entry") != "recompress_422":
        return None
    return _read(ctx)
