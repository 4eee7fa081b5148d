"""Request queue + admission control for the continuous-batching scheduler.
Twin of ``repro/serving/scheduler/queue.py``, kept as the port's own copy.

``RequestQueue`` stamps every submission with an arrival time and a
per-tier deadline (``TIER_DEADLINES``); an ``AdmissionPolicy`` then decides
— ONCE, at submission, against the scheduler's current load — whether the
request is **accepted** onto the queue, **downgraded** to a cheaper head
that still clears its ``accuracy_floor``, or **rejected** with a typed
``AdmissionRejected`` result. The budgets the shipped ``BudgetAdmission``
enforces are computed from the same ``head_catalog()`` metadata the routing
policies weigh: ``flops_per_query`` (per-shard — the decode step's critical
path, see benchmarks/README.md) bounds concurrent in-flight work, and
``memory_bytes / n_shards`` bounds which heads are eligible at all.

Admission is deliberately load-shedding, not load-hiding: a request the
budget cannot carry is refused NOW (the caller can retry, re-tier, or go
elsewhere) instead of silently queueing behind traffic it will never catch
— the backpressure half of the paper's latency story.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from repro_torch.serving.request import ServeRequest
from repro_torch.serving.router import DEFAULT_ACCURACY, head_eligible

# How long each latency tier is willing to wait for its FULL decode,
# submission to last token, in seconds. "batch" traffic never expires (and
# is therefore the first preempted when higher tiers starve — see
# ContinuousScheduler). Override per deployment via RequestQueue(deadlines=)
# / ContinuousScheduler(deadlines=).
TIER_DEADLINES: Dict[str, float] = {
    "realtime": 0.1,
    "standard": 1.0,
    "batch": math.inf,
}

# Smaller = more urgent. Preemption only ever flows downhill: a waiting
# request may displace running work of a strictly LARGER priority value.
TIER_PRIORITY: Dict[str, int] = {"realtime": 0, "standard": 1, "batch": 2}


def tier_priority(tier: str) -> int:
    """Unknown tiers rank with "standard"."""
    return TIER_PRIORITY.get(tier, TIER_PRIORITY["standard"])


@dataclass
class QueuedRequest:
    """One admitted request plus the bookkeeping the scheduler tracks:
    arrival/deadline stamps from the queue's clock, the head admission
    resolved it to (``None`` = the engine's default head instance), and the
    per-step flops cost it was charged against the admission budget."""

    id: int
    request: ServeRequest = field(repr=False)
    head: Optional[str]
    arrival: float
    deadline: float
    cost: float = 0.0
    placed_at: Optional[float] = None
    # marginal KV pages this request will allocate beyond shared-prefix
    # pages already resident (paged schedulers price admission with this;
    # 0 under the non-paged path)
    pages: int = 0
    # speculative decode assignment (repro_torch.serving.spec.SpecPolicy): the
    # draft head that speculates for this request, and the per-round draft
    # length. ``draft is None`` = plain decode.
    draft: Optional[str] = None
    draft_len: int = 0
    # resilience bookkeeping (serving/resilience): transient-fault retries
    # consumed so far, and every head this request already faulted on —
    # fallback routing never re-offers one of these
    retries: int = 0
    tried_heads: set = field(default_factory=set)

    @property
    def tier(self) -> str:
        return self.request.latency_tier

    @property
    def priority(self) -> int:
        return tier_priority(self.tier)


class RequestQueue:
    """FIFO of admitted-but-unplaced requests with arrival/deadline stamps.

    The clock is injectable so tests (and simulated-time benchmarks) drive
    deadlines deterministically; production uses ``time.monotonic``."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 deadlines: Optional[Dict[str, float]] = None):
        self.clock = clock
        self.deadlines = dict(TIER_DEADLINES if deadlines is None
                              else deadlines)
        self._items: List[QueuedRequest] = []
        self._next_id = 0

    def push(self, request: ServeRequest, head: Optional[str],
             cost: float = 0.0,
             req_id: Optional[int] = None) -> QueuedRequest:
        """``req_id`` lets the owner (the scheduler) key queue entries with
        ITS result ids — one id sequence, not two drifting ones. Standalone
        use falls back to the queue's own counter."""
        now = self.clock()
        horizon = self.deadlines.get(request.latency_tier, math.inf)
        if req_id is None:
            req_id = self._next_id
            self._next_id += 1
        qr = QueuedRequest(id=req_id, request=request, head=head,
                           arrival=now, deadline=now + horizon, cost=cost)
        self._items.append(qr)
        return qr

    def remove(self, qr: QueuedRequest) -> None:
        self._items.remove(qr)

    def requeue(self, qr: QueuedRequest) -> QueuedRequest:
        """Put a previously-admitted request back WITHOUT re-stamping: its
        arrival and deadline are properties of the submission, not of the
        fault/fallback hop that sent it back here."""
        self._items.append(qr)
        return qr

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[QueuedRequest]:
        return iter(list(self._items))     # snapshot: callers mutate mid-scan

    @property
    def flops_pending(self) -> float:
        return sum(qr.cost for qr in self._items)


# -- admission ----------------------------------------------------------------

@dataclass
class SchedulerLoad:
    """What the scheduler is already committed to, as admission sees it.

    The ``pages_*`` fields exist only under a paged scheduler
    (``ContinuousScheduler(kv_pool=...)``): ``pages_free is None`` means no
    pool is attached, and page-aware policies must not reject on memory.
    ``request_pages`` is THIS submission's marginal page demand (prompt +
    max_new pages minus shared-prefix pages already resident)."""
    flops_in_flight: float = 0.0     # per-step flops of queued + running work
    queued: int = 0                  # admitted requests not yet in a slot
    active: int = 0                  # occupied decode slots
    pages_free: Optional[int] = None   # pool pages on the free list
    pages_evictable: int = 0           # cache-held pages reclaimable under pressure
    pages_queued: int = 0              # marginal pages of admitted-unplaced work
    request_pages: int = 0             # marginal pages of the request being admitted
    # extra per-step flops THIS submission would add on top of its routed
    # head's own cost — the draft head's steps under speculative decode.
    # Only the routed-head budget fit pays it: a downgrade drops the spec
    # assignment along with the routed head, so stand-ins price plain.
    request_extra_flops: float = 0.0


@dataclass
class AdmissionDecision:
    """``action`` is "accept" | "downgrade" | "reject"; ``head`` names the
    serving head for accept/downgrade (``None`` keeps the engine default)."""
    action: str
    head: Optional[str] = None
    reason: str = ""


@dataclass
class AdmissionRejected:
    """Typed terminal result for a request the scheduler did not complete.

    ``stage`` is "admission" (refused at submit — never decoded),
    "preempt" (evicted mid-decode; ``tokens`` then carries the partial
    decode and ``head`` the head that served it), "fault" (every retry and
    fallback head exhausted — ``tokens`` carries whatever decoded before
    the terminal fault), or "timeout" (``ServeRequest.timeout_s`` elapsed;
    partial tokens attached the same way). Sits alongside ``ServeResult``
    in the scheduler's result list so callers switch on type, not on
    sentinel values."""

    request: ServeRequest = field(repr=False)
    reason: str = ""
    stage: str = "admission"
    head: Optional[str] = None
    tokens: Optional[np.ndarray] = None


def head_flops(catalog: Dict[str, dict], name: Optional[str]) -> float:
    """Per-step flops CHARGE for serving on ``name`` (0 when unknown — an
    uncataloged engine-default head costs nothing against the budget because
    the budget has no number to compare it to). Admission gating is
    stricter: ``BudgetAdmission`` refuses to ADMIT a NaN-cost head against a
    flops budget at all (``head_flops_modeled``) — this function only prices
    work that is already in flight."""
    meta = catalog.get(name) or {}
    f = meta.get("flops_per_query")
    if f is None or (isinstance(f, float) and math.isnan(f)):
        return 0.0
    return float(f)


def head_flops_modeled(catalog: Dict[str, dict], name: Optional[str]) -> bool:
    """True iff ``name``'s catalog entry carries a real (non-NaN, non-None)
    ``flops_per_query`` — the precondition for admitting it against a flops
    budget. A NaN-cost head charged via ``head_flops`` would count 0.0:
    admitted free and preferred as the "cheapest" downgrade, which is
    exactly backwards for an UNKNOWN cost."""
    f = (catalog.get(name) or {}).get("flops_per_query")
    if f is None:
        return False
    try:
        return not math.isnan(float(f))
    except (TypeError, ValueError):
        return False


class AdmissionPolicy:
    """Protocol: ``admit(request, head, catalog, load) -> AdmissionDecision``.

    ``head`` is the name routing resolved (engine-default requests arrive
    under the default head's name); ``catalog`` is ``head_catalog()``
    metadata for every candidate the scheduler knows; ``load`` is the
    current ``SchedulerLoad``. Implementations must be pure decision logic
    — the scheduler owns queueing and charging."""

    def admit(self, request: ServeRequest, head: str,
              catalog: Dict[str, dict], load: SchedulerLoad
              ) -> AdmissionDecision:
        raise NotImplementedError


class AcceptAll(AdmissionPolicy):
    """No backpressure — every request is admitted on its routed head (the
    parity configuration: scheduler results must match plain serve_batch)."""

    def admit(self, request, head, catalog, load):
        return AdmissionDecision("accept", head)


class BudgetAdmission(AdmissionPolicy):
    """Admission against per-head flops and memory budgets from the catalog.

    ``flops_budget``: ceiling on the summed per-step ``flops_per_query`` of
    all in-flight work (queued + running). A request whose routed head would
    exceed it is first offered a DOWNGRADE — the cheapest cataloged head
    that still clears its ``accuracy_floor`` (``DEFAULT_ACCURACY`` ordering,
    overridable), supports its sampling mode, fits ``memory_budget_bytes``
    per device, and fits the remaining budget — and is REJECTED with a typed
    reason only when no such head exists. ``queue_limit`` bounds the
    admitted-but-unplaced backlog regardless of flops.
    """

    def __init__(self, flops_budget: Optional[float] = None,
                 memory_budget_bytes: Optional[int] = None,
                 queue_limit: Optional[int] = None,
                 accuracy: Optional[Dict[str, float]] = None):
        self.flops_budget = flops_budget
        self.memory_budget_bytes = memory_budget_bytes
        self.queue_limit = queue_limit
        self.accuracy = {**DEFAULT_ACCURACY, **(accuracy or {})}

    def _eligible(self, name: str, meta: dict, request: ServeRequest) -> bool:
        # the same test CostAwarePolicy runs (router.head_eligible), minus
        # the wide-k exactness demand — that is a routing-quality concern,
        # not a capacity one
        return head_eligible(name, meta, request, self.accuracy,
                             memory_budget_bytes=self.memory_budget_bytes)

    def admit(self, request, head, catalog, load):
        if self.queue_limit is not None and load.queued >= self.queue_limit:
            return AdmissionDecision(
                "reject", reason=f"queue full: {load.queued} waiting >= "
                                 f"limit {self.queue_limit}")
        # pool pressure first: KV pages are head-independent, so when the
        # pool (free + cache-reclaimable, net of already-queued demand)
        # cannot back this request's marginal pages, no downgrade helps
        if load.pages_free is not None and load.request_pages > 0:
            headroom = (load.pages_free + load.pages_evictable
                        - load.pages_queued)
            if load.request_pages > headroom:
                return AdmissionDecision(
                    "reject",
                    reason=f"pool exhausted: request needs "
                           f"{load.request_pages} marginal page(s), "
                           f"{max(headroom, 0)} reclaimable "
                           f"({load.pages_free} free + "
                           f"{load.pages_evictable} evictable - "
                           f"{load.pages_queued} queued)")
        budget_left = math.inf if self.flops_budget is None else \
            self.flops_budget - load.flops_in_flight

        def costed(name):
            # with a flops budget in force, only heads with a MODELED cost
            # may be admitted or offered as downgrades — a NaN-cost head
            # would charge 0.0 and ride the budget for free
            return self.flops_budget is None or \
                head_flops_modeled(catalog, name)

        meta = catalog.get(head)
        if meta is not None and self._eligible(head, meta, request) \
                and costed(head) and (head_flops(catalog, head)
                                      + load.request_extra_flops
                                      ) <= budget_left:
            return AdmissionDecision("accept", head)
        # routed head over budget or ineligible: cheapest eligible stand-in
        alternates = sorted(
            (head_flops(catalog, n), n) for n, m in catalog.items()
            if n != head and self._eligible(n, m, request) and costed(n))
        for flops, name in alternates:
            if flops <= budget_left:
                return AdmissionDecision(
                    "downgrade", head=name,
                    reason=f"rerouted {head} -> {name} "
                           f"({flops:.3g} flops fits remaining budget)")
        if meta is None:
            reason = f"head {head!r} not in catalog and no eligible stand-in"
        elif not self._eligible(head, meta, request):
            reason = (f"no eligible head: accuracy_floor="
                      f"{request.accuracy_floor} / memory budget excludes "
                      f"all candidates")
        elif not costed(head):
            reason = (f"head {head!r} has unmodeled (NaN) flops_per_query — "
                      f"it cannot be admitted against a flops budget and no "
                      f"modeled stand-in fits")
        else:
            extra = f" + spec draft {load.request_extra_flops:.3g}" \
                if load.request_extra_flops else ""
            reason = (f"flops budget exhausted: in-flight "
                      f"{load.flops_in_flight:.3g} + {head} "
                      f"{head_flops(catalog, head):.3g}{extra} > "
                      f"{self.flops_budget:.3g}")
        return AdmissionDecision("reject", reason=reason)
