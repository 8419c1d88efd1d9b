"""Share of the traced window in which no kernel or copy ran on the card
(1 - the union of device intervals / the window). The profiler slows the
host, so this reads higher than an untraced run would."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_ns <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns / ctx.trace.window_ns)
