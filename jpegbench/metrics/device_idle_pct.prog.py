"""``device_idle_pct.prog``: ``device_idle_pct.recompress`` in the cells
of the progressive transcode's count pass: the share of the traced
window, from the first dispatch to the end of the closing synchronise, in
which no kernel, copy or fill ran on the device. It is that metric's
reader, loaded as it stands; a run that opens no ``progressive_step``
span reads None."""

from jpegbench.core.spec import metric_reader
from jpegbench.core.step_view import opens

_read = metric_reader("device_idle_pct.recompress")


def read(ctx):
    return _read(ctx) if opens(ctx.trace, "progressive_step") else None
