"""Cost-model drift audit: cataloged head costs vs measured reality.

Twin of ``repro/serving/observe/drift.py``. Routing (``CostAwarePolicy``),
admission (``BudgetAdmission``) and the spec-decode verify accounting all
price work with the heads' analytic ``flops_per_query`` /
``bytes_per_query``. Those models are written once and then drift — a
kernel change, a new screen fit, a dtype switch — and a mispriced head
silently misroutes traffic. This audit makes the drift visible: per head
it reports

* ``predicted``      — the cataloged ``describe()`` numbers,
* ``measured``       — the op count of one B = 1 ``next`` call
  (``launch/op_cost.count_cost``: ``op_flops`` / ``op_bytes``, each of the
  port's kernels one op whatever the device; the reference's
  ``hlo_flops`` / ``hlo_bytes`` / ``xla_bytes`` come from compiled HLO)
  and wall-clock seconds per single-query call, each call waited for on
  the card,
* ``ratio``          — measured / predicted (``None`` in JSON when either
  side is unmodeled).

The op count runs only for jittable, unsharded heads (sharded heads embed
collectives whose per-device accounting isn't comparable to the
per-query model; numpy heads dispatch no torch ops) — wall-clock timing
covers every head. Batch size 1 keeps the bytes numbers faithful to the
per-query cost model's convention. ``next`` is called eagerly, never
inside a CUDA graph.

The audit never throws per head: a head that fails to build or run
records an ``error`` entry so one broken backend can't hide the report
for the others.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.utils.timing import _synchronize


def _ratio(measured: float, predicted: float) -> Optional[float]:
    if (predicted is None or measured is None
            or not math.isfinite(predicted) or not math.isfinite(measured)
            or predicted <= 0):
        return None
    return measured / predicted


def _wall_per_query(head, h, iters: int, warmup: int) -> float:
    """Wall seconds per single-query ``next`` call, each call ending when
    the card has finished its output (a host head gets ``h`` on the
    host)."""
    x = h if head.is_jittable else h.cpu()
    for _ in range(warmup):
        _synchronize(head.next(x))
    t0 = time.perf_counter()
    for _ in range(iters):
        _synchronize(head.next(x))
    return (time.perf_counter() - t0) / max(1, iters)


def audit_cost_drift(engine, names: Sequence[str], *,
                     iters: int = 50, warmup: int = 3) -> Dict[str, dict]:
    """Per-head drift report for every name resolvable in ``engine``.

    Returns ``{head_name: {"predicted": {...}, "measured": {...},
    "ratio": {...}}}``, JSON-ready. Unresolvable names are skipped
    (mirroring ``head_catalog``); per-head failures downgrade to an
    ``error`` entry."""
    from repro_torch.launch.op_cost import count_cost

    h = torch.zeros((1, engine.model.cfg.d_model), dtype=torch.float32,
                    device=engine.device)
    out: Dict[str, dict] = {}
    for name in dict.fromkeys(names):
        try:
            head = engine.resolve_head(name)
        except Exception:
            continue                       # not buildable in this engine
        try:
            desc = head.describe()
            entry: Dict[str, object] = {
                "predicted": {
                    "flops_per_query": desc["flops_per_query"],
                    "bytes_per_query": desc["bytes_per_query"],
                },
            }
            measured: Dict[str, object] = {}
            with torch.inference_mode():
                if head.is_jittable and head.n_shards is None:
                    _, cost = count_cost(head.next, h)
                    measured["op_flops"] = cost.flops
                    measured["op_bytes"] = cost.bytes_accessed
                measured["wall_s_per_query"] = _wall_per_query(
                    head, h, iters, warmup)
            entry["measured"] = measured
            entry["ratio"] = {
                "flops": _ratio(measured.get("op_flops"),
                                desc["flops_per_query"]),
                "bytes": _ratio(measured.get("op_bytes"),
                                desc["bytes_per_query"]),
            }
            out[name] = entry
        except Exception as e:             # per-head guard
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out
