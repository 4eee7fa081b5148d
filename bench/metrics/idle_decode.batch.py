"""idle_decode.batch (per layer: engine decode loop; the program's spans on
the profiler's clock, ``l2sbench/spans.py``): the share of the traced
window in which the card idled while the host was in the rest of
``engine.generate``: ``engine.step`` / ``engine.capture`` (a replay and
the token's copy), ``engine.readback`` (the host waits for the card) and
the loop's own time, in %. The four ``idle_*.batch`` parts sum to
``device_idle.batch``."""
from l2sbench import spans


def read(ctx):
    return spans.read(ctx, "idle_decode")
