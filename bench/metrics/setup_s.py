"""setup_s (end to end, host clock): from the start of the process to the
opening of the window: imports, the kernels' load (and, in a checkout's
first run, their build), the weights and the screen drawn from the seed,
the engine, and the warm-up of the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
