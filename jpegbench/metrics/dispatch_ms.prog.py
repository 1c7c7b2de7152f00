"""``dispatch_ms.prog``: ``dispatch_ms.recompress`` in the cells of the
progressive transcode's count pass: the host's time in each asynchronous
call of the step (``progressive_step``: its input checks, the plan's
lookup, the ctypes arguments and the kernels' launches), on the host clock
around the call, as the mean over the window's steps. It is that metric's
reader, loaded as it stands; a run that opens no ``progressive_step`` span
reads None."""

from jpegbench.core.spec import metric_reader
from jpegbench.core.step_view import opens

_read = metric_reader("dispatch_ms.recompress")


def read(ctx):
    return _read(ctx) if opens(ctx.trace, "progressive_step") else None
