"""head_roofline.batch (per layer: kernels; the benchmark's span and
counted work): the least time of the head call's work (``work.py``: each
input byte read once, each output written once; exact: W, b and their
GEMM; screened: v, and each distinct candidate tile the rows' routes
touch, worked out in plain float32), over ``head_ms.batch``, in %."""
from l2sbench import work


def read(ctx):
    p = ctx.probe
    if p is None:
        return None
    bound = work.bound_s(p["bytes"], p["flops"], ctx.cfg["dtype"])
    return 100.0 * bound / (p["ms"] * 1e-3)
