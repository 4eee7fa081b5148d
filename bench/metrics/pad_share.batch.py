"""pad_share.batch (per layer: engine, routing; the engine's counters,
``l2sbench/spans.py``): of the rows × steps the engine decoded in the
traced window's ``engine.generate`` spans (each group padded to its
longest ``max_new``), the share no request kept: 1 − Σ kept / Σ rows ×
steps, in %."""
from l2sbench import spans


def read(ctx):
    return spans.read(ctx, "pad_share")
