"""``dispatch_ms.camera422``: ``dispatch_ms.recompress`` in the cell of
4:2:2 frames: the host's time in each asynchronous call of the step
(``full_step``: its input checks, the torch dispatch of every op and the
kernels' launches), on the host clock around the call, as the mean over
the window's steps. It is that metric's reader, loaded as it stands; a
run of another entry than ``recompress_422`` reads None."""

from jpegbench.core.spec import metric_reader

_read = metric_reader("dispatch_ms.recompress")


def read(ctx):
    if ctx.workload is None or ctx.workload.traffic.get("entry") != "recompress_422":
        return None
    return _read(ctx)
