"""device_idle (per layer: device; device trace): the share of the traced
window in which no operation (kernel, copy or set) ran on the card, in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
