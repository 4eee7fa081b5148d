"""tokens_per_s (end to end, host clock): the tokens generated for every
request of the window's jobs (each request's own ``max_new``, never the
padded steps of its group), over the window's wall time."""


def read(ctx):
    if not ctx.record.jobs:
        return None
    done = sum(int(j.lengths.sum()) for j in ctx.record.jobs)
    return float(done) / ctx.record.window_s
