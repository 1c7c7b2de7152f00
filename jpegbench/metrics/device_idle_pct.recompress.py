"""``device_idle_pct.recompress``: the share of the traced window, from the
first dispatch to the end of the closing synchronise, in which no kernel,
copy or fill ran on the device (the union of the trace's device
intervals, each instant once)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
