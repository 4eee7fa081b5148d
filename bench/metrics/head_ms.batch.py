"""head_ms.batch (per layer: heads; the benchmark's span): the mean time
of the routed head's ``next(h)`` on one job's width of contexts from the
cell's own model, CUDA events around each call, L2 flushed before it."""


def read(ctx):
    return None if ctx.probe is None else ctx.probe["ms"]
