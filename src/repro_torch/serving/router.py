"""Routing policies: ServeRequest → registry head name. Twin of
``repro/serving/router.py``; the port's heads join the accuracy table
(``screened-cuda`` at the ``screened-pallas`` operating point).

A ``RoutingPolicy`` inspects one request plus a CATALOG of head metadata
(``{name: head.describe()}`` — flops_per_query, memory_bytes, n_shards,
supports_sampling) and names the head that should serve it. The engine
builds the catalog from ``policy.candidates`` via ``head_catalog`` and
groups same-head requests into one batched decode (see
``DecodeEngine.serve_batch``), so a policy is pure request→name logic with
no execution concerns.

Shipped policies:

  StaticPolicy     everything to one head (the old single-head behavior)
  TierPolicy       latency_tier → head name lookup
  CostAwarePolicy  cheapest head (per-shard flops_per_query) that satisfies
                   the request's accuracy floor, k width, sampling needs,
                   and a per-device memory budget — the budget is what
                   pushes big-vocab heads onto their sharded variants

An explicit ``request.head`` always wins; policies never see it.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.serving.request import ServeRequest

# Nominal decode fidelity per registry head — the fraction of greedy tokens
# expected to agree with the exact softmax, the quantity ServeRequest's
# accuracy_floor is compared against. Exact heads are 1.0 by construction
# (the sharded merge is bit-identical to single-device top-k); the screened
# family is the paper's ~P@1 0.99 operating point; the §4.1 baselines use
# the paper's Table-1 orderings. Override per deployment via
# CostAwarePolicy(accuracy=...) once measured agreement is available.
DEFAULT_ACCURACY: Dict[str, float] = {
    "exact": 1.0, "exact-sharded": 1.0,
    "screened": 0.99, "screened-sharded": 0.99, "screened-pallas": 0.99,
    "screened-cuda": 0.99, "screened-cpu": 0.99,
    "adaptive": 0.98, "adaptive-sharded": 0.98,
    "svd": 0.95, "shortlist": 0.90, "greedy-mips": 0.85,
    "lsh-mips": 0.70, "pca-mips": 0.70,
}

# Heads whose decode is provably exact BY CONSTRUCTION (the sharded merge is
# bit-identical to single-device top-k). An ``accuracy_floor`` of exactly
# 1.0 means "no approximation tolerated" and is only satisfiable by these:
# a MEASURED agreement estimate that rounds to float 1.0 (or a floor
# computed as 1.0 − ε that rounds back to 1.0) must never promote an
# approximate head past it.
EXACT_HEADS = frozenset({"exact", "exact-sharded"})


def head_eligible(name: str, meta: dict, request: ServeRequest,
                  accuracy: Dict[str, float],
                  memory_budget_bytes: Optional[int] = None,
                  wide_k: Optional[int] = None) -> bool:
    """The eligibility test of ``CostAwarePolicy``: accuracy floor (raised
    to exactness for k > ``wide_k`` when given — an approximate head's
    candidate list may not contain k valid words), sampling support, and
    the per-device memory fit ``memory_bytes / n_shards``."""
    floor = request.accuracy_floor
    if wide_k is not None and request.k > wide_k:
        floor = max(floor, 1.0)
    if floor >= 1.0:
        # exactness demanded: membership test against the exact-head
        # sentinel, NOT a >= comparison on a measured estimate
        if name not in EXACT_HEADS:
            return False
    elif accuracy.get(name, 0.0) < floor:
        return False
    if request.sampled and not meta.get("supports_sampling", True):
        return False
    if memory_budget_bytes is not None:
        per_device = meta.get("memory_bytes", 0) / \
            max(1, meta.get("n_shards") or 1)
        if per_device > memory_budget_bytes:
            return False
    return True


class RoutingPolicy:
    """Protocol: ``route(request, catalog) -> head name``.

    ``candidates`` lists every head name the policy may emit — the engine
    resolves exactly these to build the catalog (and to warm its step
    cache), so keep it tight."""

    candidates: Sequence[str] = ()

    def route(self, request: ServeRequest, catalog: Dict[str, dict]) -> str:
        raise NotImplementedError


class StaticPolicy(RoutingPolicy):
    """Every request to one head — `serve_batch(requests)`'s default, and
    the bridge from the old single-head calling convention."""

    def __init__(self, head: str):
        self.head = head
        self.candidates = (head,)

    def route(self, request: ServeRequest, catalog: Dict[str, dict]) -> str:
        return self.head


class TierPolicy(RoutingPolicy):
    """latency_tier → head name lookup.

        TierPolicy({"realtime": "screened", "batch": "exact"},
                   default="screened")

    Unknown tiers fall back to ``default``."""

    def __init__(self, tiers: Dict[str, str], default: str = "exact"):
        self.tiers = dict(tiers)
        self.default = default
        self.candidates = tuple(dict.fromkeys(
            list(self.tiers.values()) + [default]))

    def route(self, request: ServeRequest, catalog: Dict[str, dict]) -> str:
        return self.tiers.get(request.latency_tier, self.default)


class CostAwarePolicy(RoutingPolicy):
    """Pick the cheapest eligible head by its analytic cost model.

    Eligibility per request:
      - accuracy:  head accuracy (``accuracy`` table, DEFAULT_ACCURACY
                   fallback) >= request.accuracy_floor;
      - width:     requests with k > ``wide_k`` need exact-accuracy heads —
                   an approximate head's candidate list may simply not
                   contain k valid words;
      - sampling:  sampled requests only go to supports_sampling heads;
      - memory:    with ``memory_budget_bytes`` set, a head must fit the
                   PER-DEVICE budget: memory_bytes / n_shards. This is the
                   knob that routes memory-pressured big-vocab traffic to
                   "*-sharded" heads while small models stay single-device.

    Among eligible heads, "batch"-tier requests take the highest-accuracy
    head (quality-first — the caller already said it can wait), everything
    else takes the lowest per-shard ``flops_per_query``; flops ties break
    on ``bytes_per_query`` (the decode-step device-memory profile — how the
    fused CUDA head beats the equal-flops torch screened head), then toward
    the earlier candidate. ``fallback`` (default "exact") serves requests no
    candidate is eligible for."""

    def __init__(self, candidates: Iterable[str],
                 accuracy: Optional[Dict[str, float]] = None,
                 memory_budget_bytes: Optional[int] = None,
                 wide_k: int = 32, fallback: str = "exact"):
        cands = tuple(dict.fromkeys(candidates))
        self.accuracy = {**DEFAULT_ACCURACY, **(accuracy or {})}
        self.memory_budget_bytes = memory_budget_bytes
        self.wide_k = wide_k
        self.fallback = fallback
        self.candidates = cands if fallback in cands else cands + (fallback,)

    def _eligible(self, name: str, meta: dict, request: ServeRequest) -> bool:
        return head_eligible(name, meta, request, self.accuracy,
                             memory_budget_bytes=self.memory_budget_bytes,
                             wide_k=self.wide_k)

    def route(self, request: ServeRequest, catalog: Dict[str, dict]) -> str:
        eligible = [(name, catalog[name]) for name in self.candidates
                    if name in catalog
                    and self._eligible(name, catalog[name], request)]
        if not eligible:
            return self.fallback
        if request.latency_tier == "batch":
            return max(eligible,
                       key=lambda nm: self.accuracy.get(nm[0], 0.0))[0]

        def cost(meta):
            # flops_per_query is documented "NaN when unmodeled"
            # (heads/base.py); an unmodeled head is INELIGIBLE FOR COST
            # RANKING — returning inf here would still let it win or lose
            # on the bytes tie-break, which is meaningless without a flops
            # model to tie on
            f = meta.get("flops_per_query")
            if f is None or math.isnan(f):
                return None
            return float(f)

        def mem_cost(meta):
            # memory-profile tie-break between equal-flops heads: the fused
            # CUDA head does the same MACs as the torch screened head but
            # moves far fewer device-memory bytes per decode step, and should
            # win regardless of candidate order
            b = meta.get("bytes_per_query")
            return math.inf if b is None or math.isnan(b) else b

        modeled = [(name, meta) for name, meta in eligible
                   if cost(meta) is not None]
        if not modeled:
            # every eligible head is unmodeled: candidate (tier) order
            # decides — never a comparison against NaN
            return eligible[0][0]
        return min(modeled, key=lambda nm: (cost(nm[1]),
                                            mem_cost(nm[1])))[0]


def route_requests(requests: Sequence[ServeRequest], policy: RoutingPolicy,
                   catalog: Dict[str, dict]) -> List[str]:
    """Resolve every request to a head name: explicit ``request.head`` wins,
    otherwise the policy decides from the catalog."""
    names = []
    for req in requests:
        name = req.head if req.head is not None else \
            policy.route(req, catalog)
        if not isinstance(name, str):
            raise TypeError(f"policy {type(policy).__name__} returned "
                            f"{name!r}; routes must be registry head names")
        names.append(name)
    return names
