"""idle_client.batch (per layer: client; the program's spans on the
profiler's clock, ``l2sbench/spans.py``): the share of the traced window
in which the card idled while the host was the benchmark's own loop:
outside every ``serve_batch`` span, in %. The four ``idle_*.batch``
parts sum to ``device_idle.batch``."""
from l2sbench import spans


def read(ctx):
    return spans.read(ctx, "idle_client")
