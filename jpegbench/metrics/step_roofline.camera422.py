"""``step_roofline.camera422``: the whole 4:2:2 step against its bound, over
the window on the host clock, as ``step_roofline.recompress`` reads its
4:2:0 step: steps x the step's bound over the window.

The step's bound is its interface's bytes at the memory rate: the int16
coefficients in (a luma and two half-size chroma coefficients a pixel:
4 B), the uint8 RGB out (3 B) and the int16 requantised luma out (2 B),
9 B a processed pixel. It bounds every kernel the step runs, so it stays
when a kernel leaves the path. The bound is the 4:2:2 step's: a run of
another entry than ``recompress_422`` reads None."""

from jpegbench.core.peaks import bound_s


def step_bound_s(shape) -> float:
    pixels = shape["batch"] * shape["hb"] * shape["wb"] * 64
    coefficients = pixels + 2 * (pixels // 2)
    return bound_s(coefficients * 2 + pixels * 3 + pixels * 2)


def read(ctx):
    w = ctx.window
    if ctx.workload is None or ctx.workload.traffic.get("entry") != "recompress_422":
        return None
    if not w.steps or w.seconds <= 0.0:
        return None
    return 100.0 * w.steps * step_bound_s(ctx.shape) / w.seconds
