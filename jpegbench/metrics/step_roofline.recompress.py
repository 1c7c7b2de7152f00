"""``step_roofline.recompress``: the whole step against its bound, over the
window on the host clock: steps x the step's bound over the window.

The step's bound is its interface's bytes at the memory rate: the int16
coefficients in (a luma and two quarter-size chroma coefficients a
pixel: 3 B), the uint8 RGB out (3 B) and the int16 requantised luma out
(2 B), 8 B a processed pixel. It bounds every kernel the step runs, so it
stays when a kernel leaves the path."""

from jpegbench.core.peaks import bound_s


def step_bound_s(shape) -> float:
    b, hb, wb = shape["batch"], shape["hb"], shape["wb"]
    pixels = b * hb * wb * 64
    coefficients = pixels + 2 * (pixels // 4)
    return bound_s(coefficients * 2 + pixels * 3 + pixels * 2)


def read(ctx):
    w = ctx.window
    if not w.steps or w.seconds <= 0.0:
        return None
    return 100.0 * w.steps * step_bound_s(ctx.shape) / w.seconds
