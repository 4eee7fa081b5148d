"""idle_serve.batch (per layer: engine, routing; the program's spans on the
profiler's clock, ``l2sbench/spans.py``): the share of the traced window
in which the card idled while the host was in ``serve_batch`` but
outside every ``engine.generate``: ``serve.route`` (the catalog, the
policy's routes, the grouping), ``serve.results`` and the call's own
time, in %. The four ``idle_*.batch`` parts sum to
``device_idle.batch``."""
from l2sbench import spans


def read(ctx):
    return spans.read(ctx, "idle_serve")
