"""``dispatch_ms.recompress``: the host's time in each asynchronous call of
the step (``full_step``: its input checks, the torch dispatch of every op
and the kernels' launches), on the host clock around the call, as the
mean over the window's steps. It matters once the card waits for the
host; with no step in the window there is nothing to read."""


def read(ctx):
    calls = ctx.window.dispatch_s
    return 1e3 * sum(calls) / len(calls) if calls else None
