"""idle_prefill.batch (per layer: model step, its eager prefill; the
program's spans on the profiler's clock, ``l2sbench/spans.py``): the
share of the traced window in which the card idled while the host was in
``engine.prefill`` (the eager prefill, one launch set a position) or
``engine.first`` (the first token from the prompt's last state), in %.
The four ``idle_*.batch`` parts sum to ``device_idle.batch``."""
from l2sbench import spans


def read(ctx):
    return spans.read(ctx, "idle_prefill")
