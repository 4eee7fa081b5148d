"""The continuous-batching scheduler: admission → microbatch → retire.
Twin of ``repro/serving/scheduler/scheduler.py``.

``ContinuousScheduler`` turns ``DecodeEngine`` from a batch-decode library
into a server. Requests arrive one at a time (``submit``); each is routed
to a head (explicit ``request.head``, else the ``RoutingPolicy``), passed
through the ``AdmissionPolicy`` against the current load, and — if admitted
— queued with an arrival stamp and tier deadline. Each ``step()`` tick
then:

  1. PLACES waiting requests into head-keyed ``DecodeStream`` microbatches
     (fixed width ``max_slots``; join-at-step — a request enters a RUNNING
     stream's free pad slot at a sequence boundary, no new graph, no wait
     for the stream to drain);
  2. ADVANCES every live stream one token through the engine's cached
     steps (graph replays on the card);
  3. RETIRES finished sequences as ``ServeResult``s (greedy tokens equal
     to ``serve_batch``'s — each stream row is computed independently);
  4. PREEMPTS lower-tier work for starving higher-tier requests — a victim
     must be past its deadline (or best-effort "batch" work, which has
     none) AND its eviction must actually free capacity the waiter can
     use; it surfaces as a typed ``AdmissionRejected(stage="preempt")``
     with its partial tokens.

``drain()`` runs ticks until the system is empty and returns results in
submission order; ``serve(requests)`` is submit-all + drain, the drop-in
continuous counterpart to ``engine.serve_batch``.

RESILIENCE (``repro_torch.serving.resilience``): with a ``fault_injector`` /
``breaker`` / ``watchdog`` attached, the tick additionally absorbs typed
``HeadFault``s from the stream guards — transient faults retry in place
with bounded tick-backoff (the stream rolls the refused step back, so
greedy retries are bit-identical), permanent or retry-exhausted faults offload the
stream (full KV-page rollback via the same eviction machinery preemption
uses) and re-route each request to the cheapest healthy head clearing its
``accuracy_floor`` (exact as last resort), else terminate it as a typed
``AdmissionRejected(stage="fault")`` with partial tokens. The server
degrades; it never crashes, never leaks a page, never loops forever
(``drain`` raises typed ``SchedulerStalled``).
"""
from __future__ import annotations

import math
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.serving.engine import DecodeEngine, DecodeStream
from repro_torch.serving.kvpool.pool import PoolExhausted
from repro_torch.serving.observe.trace import NULL_TRACER
from repro_torch.serving.request import ServeRequest, ServeResult
from repro_torch.serving.resilience.breaker import OPEN
from repro_torch.serving.resilience.faults import HeadFault
from repro_torch.serving.router import DEFAULT_ACCURACY, head_eligible
from repro_torch.serving.scheduler.queue import (AcceptAll, AdmissionPolicy,
                                           AdmissionRejected, QueuedRequest,
                                           RequestQueue, SchedulerLoad,
                                           head_flops, head_flops_modeled,
                                           tier_priority)
from repro_torch.serving.scheduler.stats import ServerStats


class SchedulerStalled(RuntimeError):
    """``drain()`` could not finish: nothing progressed for several ticks
    (queued work that can never place) or the ``max_ticks`` safety valve
    fired. Carries the stuck request ids and the final ``ServerStats``
    snapshot so the operator sees WHAT wedged, not just that it did."""

    def __init__(self, message: str, rids: Sequence[int] = (),
                 stats: Optional[dict] = None):
        super().__init__(message)
        self.rids = tuple(rids)
        self.stats = stats


class ContinuousScheduler:
    """Admission-controlled continuous batching over one ``DecodeEngine``.

    ``policy``      RoutingPolicy resolving requests to head names
                    (``None`` = everything on the engine's default head).
    ``admission``   AdmissionPolicy (default ``AcceptAll`` — pure
                    continuous batching, no backpressure).
    ``max_slots``   width of every decode stream (pad slots = live
                    capacity; fixed so warm steps capture no new graph).
    ``max_streams`` concurrent streams; idle streams are recycled LRU when
                    a new (head, sampling) signature needs a lane.
    ``deadlines``   {tier: seconds} override of ``TIER_DEADLINES``.
    ``clock``       injectable monotonic clock for arrival/deadline/latency
                    bookkeeping (tests pass a fake; throughput telemetry
                    always uses the real wall clock).
    ``kv_pool``     optional ``repro_torch.serving.kvpool.PagePool``: streams
                    become ``PagedDecodeStream``s sharing the pool's pages
                    and shared-prefix radix cache; admission prices each
                    request by its MARGINAL pages (prompt + max_new pages
                    minus radix-resident prefix pages); ``PoolExhausted``
                    at placement or step becomes a first-class pressure
                    signal — the radix cache reclaims LRU prefixes first,
                    then stage 3 preempts expendable lower-tier work, and
                    after two consecutive stalled ticks the lowest-tier
                    running slot is force-evicted so the pool can never
                    livelock a full stream set.
    ``spec``        optional ``repro_torch.serving.spec.SpecPolicy``: requests
                    ACCEPTED on their routed head may additionally get a
                    cheap draft head and run on a ``SpecDecodeStream``
                    (emitted tokens stay the verify head's — speculation
                    never changes output). Admission prices the draft
                    head's extra per-step flops
                    (``SchedulerLoad.request_extra_flops``) and, under a
                    pool, the ``draft_len − 1`` rollback pages a round can
                    transiently write; a DOWNGRADE drops the spec
                    assignment along with the routed head.
    ``fault_injector`` optional ``resilience.FaultInjector`` armed on every
                    stream the scheduler opens (chaos testing; the guards
                    run regardless and catch honest degeneration too).
    ``breaker``     optional ``resilience.CircuitBreaker``: fault signals
                    feed it, open heads drop out of routing/admission/spec
                    (``head_eligible``'s ``breaker_open`` stamp) and their
                    running streams are offloaded to fallbacks.
    ``watchdog``    optional ``resilience.StreamWatchdog``: per-request
                    progress tracking; stalled requests are evicted and
                    re-routed like faulted ones.
    ``max_retries`` transient-fault retries per request before fallback
                    re-routing (exponential tick-backoff, capped at 8).
    ``tracer``      optional ``observe.Tracer``: per-request span timeline
                    (submit → admit/queue/join → decode → retire, plus
                    every fault/retry/fallback instant), scheduler-tick
                    spans and the streams' kernel-dispatch spans. Give it
                    the SAME clock as the scheduler so the timeline and
                    the deadline machinery share an axis. ``None`` keeps
                    the hot path on the allocation-free ``NULL_TRACER``.
    """

    def __init__(self, engine: DecodeEngine, policy=None,
                 admission: Optional[AdmissionPolicy] = None,
                 max_slots: int = 4, max_streams: int = 8,
                 deadlines: Optional[Dict[str, float]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 kv_pool=None, spec=None, fault_injector=None,
                 breaker=None, watchdog=None, max_retries: int = 2,
                 tracer=None):
        if max_slots < 1 or max_streams < 1:
            raise ValueError("max_slots and max_streams must be >= 1")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0: {max_retries}")
        self.engine = engine
        self.kv_pool = kv_pool
        self.spec = spec
        self._pool_stalled_ticks = 0    # consecutive ticks blocked on pages
        self.policy = policy
        self.admission = admission if admission is not None else AcceptAll()
        self.max_slots = int(max_slots)
        self.max_streams = int(max_streams)
        self.clock = clock
        self.queue = RequestQueue(clock=clock, deadlines=deadlines)
        self.stats = ServerStats()
        self._streams: "OrderedDict[tuple, DecodeStream]" = OrderedDict()
        self._results: Dict[int, object] = {}
        self._order: List[int] = []
        self._next_rid = 0          # monotonic even after pop_results()
        self._inflight: Dict[int, QueuedRequest] = {}   # placed, not finished
        self._catalog: Dict[str, dict] = {}
        # -- resilience wiring (all optional; zero cost when absent) ---------
        self.fault_injector = fault_injector
        self.breaker = breaker
        self.watchdog = watchdog
        self.max_retries = int(max_retries)
        self.fault_rids: set = set()    # rids any fault/retry/fallback touched
        self._retry_at: Dict[tuple, int] = {}   # stream sig -> resume tick
        self._fail_count: Dict[tuple, int] = {}  # sig -> consecutive faults
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._trace_t0: Dict[int, float] = {}   # rid -> submit stamp
        if breaker is not None:
            # chain the breaker's transition hook through ServerStats so
            # trips/half-opens/closes are observable in every snapshot
            user_cb = breaker.on_transition

            def _on_transition(head, old, new, _user=user_cb):
                self.stats.record_breaker(head, old, new)
                if _user is not None:
                    _user(head, old, new)
            breaker.on_transition = _on_transition
        # live-source collectors: watchdog tracking + per-lane adaptive
        # draft length refresh into the stats' typed-metrics registry at
        # every exposition (ServerStats' own counters are mirrored by its
        # own collector; these two sources live outside it)
        self.stats.metrics.register_collector(self._collect_live_metrics)

    def _collect_live_metrics(self) -> None:
        m = self.stats.metrics
        if self.watchdog is not None:
            m.gauge("serve_watchdog_tracked",
                    "requests under stall tracking").set(
                self.watchdog.tracked)
        for stream in self._streams.values():
            ctl = getattr(stream, "controller", None)
            if ctl is None:
                continue
            lane = f"{stream.draft_name}->{stream.verify_name}"
            m.gauge("serve_spec_draft_len",
                    "adaptive draft length per spec lane",
                    ("lane",)).set(ctl.n, lane=lane)
            m.gauge("serve_spec_draft_acceptance",
                    "EMA draft acceptance per spec lane",
                    ("lane",)).set(ctl.acceptance, lane=lane)

    # -- tracing -------------------------------------------------------------
    def _trace_terminal(self, rid: int, outcome: str,
                        head: Optional[str] = None,
                        n_tokens: Optional[int] = None) -> None:
        """Close request ``rid``'s top-level span: one "request" span from
        its submit stamp to now, on its own trace lane (``tid = rid``),
        emitted at EVERY terminal site — completed, rejected, preempted,
        faulted or timed out — so the submit→retire coverage the traced CI
        smoke asserts holds for every funnel exit."""
        tr = self.tracer
        if not tr.enabled:
            return
        t0 = self._trace_t0.pop(rid, None)
        args = {"outcome": outcome}
        if head is not None:
            args["head"] = head
        if n_tokens is not None:
            args["tokens"] = n_tokens
        tr.span("request", "request", tr.now() if t0 is None else t0,
                tid=rid, args=args)

    # -- catalog / routing ---------------------------------------------------
    def _default_name(self) -> str:
        return getattr(self.engine.head, "name", "__engine-default__")

    def _ensure_catalog(self, names: Sequence[str]) -> Dict[str, dict]:
        missing = [n for n in names if n and n not in self._catalog]
        if missing:
            self._catalog.update(self.engine.head_catalog(missing))
        return self._catalog

    def _health_view(self, catalog: Dict[str, dict]) -> Dict[str, dict]:
        """Catalog filtered through the circuit breaker: heads whose
        breaker is open get a ``breaker_open`` stamp on a COPY of their
        meta, which ``head_eligible`` (routing + admission + spec policy)
        treats as a veto. ``allow()`` doubles as the half-open transition
        probe — an open head past its cooldown un-stamps itself here."""
        if self.breaker is None:
            return catalog
        out = {}
        for name, meta in catalog.items():
            if not self.breaker.allow(name):
                meta = dict(meta)
                meta["breaker_open"] = True
            out[name] = meta
        return out

    def _route(self, request: ServeRequest) -> Optional[str]:
        """Explicit head > policy > engine default (``None``)."""
        if request.head is not None:
            return request.head
        if self.policy is None:
            return None
        catalog = self._ensure_catalog(
            tuple(getattr(self.policy, "candidates", ())))
        return self.policy.route(request, self._health_view(catalog))

    def _load(self) -> SchedulerLoad:
        running = sum(qr.cost for qr in self._inflight.values())
        load = SchedulerLoad(
            flops_in_flight=self.queue.flops_pending + running,
            queued=len(self.queue),
            active=sum(s.n_active for s in self._streams.values()))
        pool = self.kv_pool
        if pool is not None:
            load.pages_free = pool.pages_free
            load.pages_evictable = pool.radix.evictable_pages() \
                if pool.radix is not None else 0
            load.pages_queued = sum(qr.pages for qr in self.queue)
        return load

    def _marginal_pages(self, request: ServeRequest,
                        draft_slack: int = 0) -> int:
        """Pages this request will newly allocate: its full footprint
        (prompt + decode budget) minus fully-shared prefix pages already
        resident in the radix cache (a peek — no LRU side effects).

        ``draft_slack`` (speculative requests: ``draft_len − 1``) is the
        rollback overshoot a draft/verify round can transiently write past
        the final token; spec streams reserve it up front and never dedupe
        through the radix cache, so shared-prefix credit does not apply."""
        pool = self.kv_pool
        P = pool.page_size
        total = int(request.prompt.shape[0]) + int(request.max_new) \
            + int(draft_slack)
        shared = 0
        if draft_slack == 0 and pool.radix is not None:
            m = pool.radix.match([int(t) for t in request.prompt], peek=True)
            shared = sum(1 for _, nv in m.chain if nv == P)
        return max(0, (total + P - 1) // P - shared)

    # -- submission (admission happens HERE, against current load) -----------
    def submit(self, request: ServeRequest) -> int:
        """Admit-or-refuse one request. Returns its result id; rejected
        requests get their typed ``AdmissionRejected`` immediately."""
        Tp = int(request.prompt.shape[0])
        if Tp + request.max_new > self.engine.max_len:
            raise ValueError(
                f"request needs {Tp + request.max_new} cache slots, engine "
                f"max_len is {self.engine.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._order.append(rid)
        self.stats.submitted += 1
        tr = self.tracer
        if tr.enabled:
            self._trace_t0[rid] = tr.now()
            tr.instant("submit", "request", tid=rid,
                       args={"tier": request.latency_tier,
                             "max_new": int(request.max_new)})
        routed = self._route(request)
        name = routed if routed is not None else self._default_name()
        # admission's downgrade universe must not depend on submission
        # history: it is EXACTLY the policy's candidates plus this
        # request's routed head — never other requests' explicit heads
        # that happen to sit in the accumulated catalog
        cand = tuple(getattr(self.policy, "candidates", ())) \
            if self.policy is not None else ()
        spec_cand = tuple(getattr(self.spec, "candidates", ())) \
            if self.spec is not None else ()
        names = tuple(dict.fromkeys(
            cand + spec_cand + (() if routed is None else (routed,))))
        self._ensure_catalog(names)
        catalog = {n: self._catalog[n] for n in names if n in self._catalog}
        if routed is None:
            catalog[name] = self.engine.head.describe()
        catalog = self._health_view(catalog)
        # provisional spec assignment BEFORE admission, so admission prices
        # the draft head's extra per-step flops and the rollback pages; a
        # downgrade drops it again below
        draft = None
        draft_len = 0
        if self.spec is not None:
            draft = self.spec.draft_for(request, name, catalog,
                                        max_len=self.engine.max_len)
            if draft is not None:
                draft_len = self.spec.draft_len_for(request,
                                                    self.engine.max_len)
        load = self._load()
        if self.kv_pool is not None:
            load.request_pages = self._marginal_pages(
                request, draft_slack=draft_len - 1 if draft else 0)
        if draft is not None:
            load.request_extra_flops = head_flops(catalog, draft)
        decision = self.admission.admit(request, name, catalog, load)
        if decision.action != "accept" and draft is not None:
            # speculation is OPTIONAL: before letting the draft's extra
            # flops/pages downgrade (or reject) the routed head, retry the
            # admission PLAIN — dropping the draft must always be preferred
            # to dropping the head the router chose
            draft, draft_len = None, 0
            load.request_extra_flops = 0.0
            if self.kv_pool is not None:
                load.request_pages = self._marginal_pages(request)
            decision = self.admission.admit(request, name, catalog, load)
        if decision.action == "reject":
            self._results[rid] = AdmissionRejected(
                request=request, reason=decision.reason, stage="admission")
            self.stats.rejected += 1
            if tr.enabled:
                tr.instant("reject", "admission", tid=rid,
                           args={"reason": decision.reason})
                self._trace_terminal(rid, "rejected", head=name)
            return rid
        if decision.action == "downgrade":
            self.stats.downgraded += 1
            head = decision.head
            if tr.enabled:
                tr.instant("downgrade", "admission", tid=rid,
                           args={"from": name, "to": head})
        else:
            head = routed        # None keeps the engine default instance
        if tr.enabled:
            tr.instant("admit", "admission", tid=rid,
                       args={"head": decision.head or name,
                             **({"draft": draft} if draft else {})})
        cost = head_flops(catalog, decision.head or name)
        if draft is not None:
            cost += head_flops(catalog, draft)
        qr = self.queue.push(request, head, cost=cost, req_id=rid)
        qr.pages = load.request_pages
        qr.draft = draft
        qr.draft_len = draft_len
        self.stats.admitted += 1
        self.stats.observe_queue(len(self.queue))
        return rid

    # -- stream management ---------------------------------------------------
    @staticmethod
    def _sig(qr: QueuedRequest) -> tuple:
        """Stream signature: head + the request's ``sampling_key()`` (the
        same statics serve_batch's group_key carries, minus the prompt
        length — streams prefill per request, so mixed-length traffic
        shares a lane, unlike serve_batch's batched prefill groups).
        Speculative requests carry their (draft head, draft length) too —
        a spec lane's round shape is a stream-wide static."""
        sig = (qr.head,) + qr.request.sampling_key()
        if qr.draft is not None:
            sig += ("spec", qr.draft, qr.draft_len)
        return sig

    def _stream_for(self, qr: QueuedRequest) -> Optional[DecodeStream]:
        sig = self._sig(qr)
        stream = self._streams.get(sig)
        if stream is not None:
            self._streams.move_to_end(sig)
            return stream if stream.free_slots else None
        if len(self._streams) >= self.max_streams:
            for key, s in list(self._streams.items()):   # recycle idle, LRU
                if s.idle:
                    del self._streams[key]
                    break
            else:
                return None
        req = qr.request
        if qr.draft is not None:
            stream = self.engine.open_spec_stream(
                draft_head=qr.draft, verify_head=qr.head,
                width=self.max_slots, draft_len=qr.draft_len,
                temperature=req.temperature, top_p=req.top_p, seed=req.seed,
                kv_pool=self.kv_pool,
                adaptive=getattr(self.spec, "adaptive", True))
        elif self.kv_pool is not None:
            stream = self.engine.open_paged_stream(
                self.kv_pool, head=qr.head, width=self.max_slots,
                temperature=req.temperature, top_p=req.top_p, seed=req.seed)
        else:
            stream = self.engine.open_stream(
                head=qr.head, width=self.max_slots,
                temperature=req.temperature, top_p=req.top_p, seed=req.seed)
        stream.fault_injector = self.fault_injector
        stream.tracer = self.tracer
        self._streams[sig] = stream
        return stream

    # -- resilience helpers ---------------------------------------------------
    @staticmethod
    def _stream_heads(stream) -> tuple:
        """The registry head name(s) a stream's health hangs on: (draft,
        verify) for spec lanes, the serving head otherwise."""
        if hasattr(stream, "draft_name"):
            return (stream.draft_name, stream.verify_name)
        return (stream.head_name,)

    def _fallback_head(self, qr: QueuedRequest) -> Optional[str]:
        """Cheapest healthy head this request can still run on: policy
        candidates + everything cataloged + "exact" (the last resort —
        by flops it naturally ranks last), minus heads the request already
        faulted on and heads the breaker has open, filtered through the
        same ``head_eligible`` test routing and admission share."""
        cand = tuple(getattr(self.policy, "candidates", ())) \
            if self.policy is not None else ()
        names = tuple(dict.fromkeys(
            cand + tuple(self._catalog) + ("exact",)))
        try:
            self._ensure_catalog(names)
        except Exception:
            names = tuple(n for n in names if n in self._catalog)
        catalog = self._health_view(
            {n: self._catalog[n] for n in names if n in self._catalog})
        acc = {**DEFAULT_ACCURACY,
               **(getattr(self.policy, "accuracy", None) or {})}
        best = None
        for n, meta in catalog.items():
            if n in qr.tried_heads:
                continue
            if not head_eligible(n, meta, qr.request, acc):
                continue
            f = head_flops(catalog, n) if head_flops_modeled(catalog, n) \
                else math.inf
            if best is None or f < best[0]:
                best = (f, n)
        return None if best is None else best[1]

    def _redispatch(self, qr: QueuedRequest, failed_head: str,
                    partial=None) -> int:
        """One offloaded request after a permanent/exhausted fault or
        stall: strip a faulting DRAFT and requeue plain (emitted tokens
        were always the verify head's — degrading costs nothing), else
        re-route to the cheapest healthy head, else terminate typed.
        Returns 1 when the request reached a terminal state."""
        self.fault_rids.add(qr.id)
        self._inflight.pop(qr.id, None)
        if self.watchdog is not None:
            self.watchdog.forget(qr.id)
        tr = self.tracer
        if qr.draft is not None and failed_head == qr.draft:
            qr.draft, qr.draft_len = None, 0
            qr.retries = 0
            self.stats.record_spec_degraded()
            if tr.enabled:
                tr.instant("spec_degrade", "resilience", tid=qr.id,
                           args={"draft": failed_head})
            self.queue.requeue(qr)
            return 0
        qr.tried_heads.add(failed_head)
        fallback = self._fallback_head(qr)
        if fallback is not None:
            self.stats.record_fallback(failed_head, fallback)
            if tr.enabled:
                tr.instant("fallback", "resilience", tid=qr.id,
                           args={"from": failed_head, "to": fallback})
            qr.head = fallback
            qr.cost = head_flops(self._catalog, fallback)
            qr.draft, qr.draft_len = None, 0
            qr.retries = 0
            self.queue.requeue(qr)
            return 0
        self._results[qr.id] = AdmissionRejected(
            request=qr.request, stage="fault", head=failed_head,
            tokens=partial,
            reason=f"head {failed_head!r} faulted and no healthy head "
                   f"clears accuracy_floor={qr.request.accuracy_floor} "
                   f"(tried {sorted(qr.tried_heads)})")
        self.stats.record_faulted()
        self._trace_terminal(qr.id, "faulted", head=failed_head)
        return 1

    def _offload_stream(self, sig: tuple, stream, failed_head: str) -> int:
        """Evict every occupant of a sick stream (full KV-page rollback —
        ``evict`` releases page chains exactly like preemption) and
        re-route each through ``_redispatch``."""
        terminal = 0
        for slot, tag in list(stream.occupied()):
            _, _, partial = stream.evict(slot)
            terminal += self._redispatch(tag, failed_head, partial=partial)
        self._retry_at.pop(sig, None)
        self._fail_count.pop(sig, None)
        return terminal

    def _on_stream_fault(self, sig: tuple, stream, e: HeadFault) -> int:
        """Typed fault out of a stream's step: transient faults retry in
        place with bounded exponential tick-backoff (the stream rolled the
        refused step back, so the retry re-runs the identical step);
        permanent or retry-exhausted faults offload the stream and
        re-route its requests. Either way the breaker hears about it."""
        self.stats.record_fault(e.kind, e.transient)
        tr = self.tracer
        for _, tag in stream.occupied():
            self.fault_rids.add(tag.id)
            if tr.enabled:
                tr.instant("fault", "resilience", tid=tag.id,
                           args={"head": e.head, "kind": e.kind,
                                 "transient": e.transient})
        if self.breaker is not None:
            self.breaker.record_failure(e.head, kind=e.kind,
                                        hard=not e.transient)
        tripped = self.breaker is not None and \
            self.breaker.state(e.head) == OPEN
        if e.transient and not tripped:
            fails = self._fail_count.get(sig, 0) + 1
            self._fail_count[sig] = fails
            if fails <= self.max_retries:
                self.stats.record_retry()
                self._retry_at[sig] = self.stats.ticks + min(
                    2 ** (fails - 1), 8)
                if tr.enabled:
                    for _, tag in stream.occupied():
                        tr.instant("retry", "resilience", tid=tag.id,
                                   args={"head": e.head, "attempt": fails})
                return 0
        terminal = self._offload_stream(sig, stream, e.head)
        if tripped:
            # the breaker took the whole HEAD out, not just this stream:
            # offload every other lane it serves (or drafts for) too
            for other_sig, other in list(self._streams.items()):
                if other is stream or e.head not in \
                        self._stream_heads(other):
                    continue
                if other.n_active:
                    terminal += self._offload_stream(other_sig, other,
                                                     e.head)
        return terminal

    # -- the tick ------------------------------------------------------------
    def step(self) -> int:
        """One scheduler tick. Returns the number of requests that reached
        a terminal state (completed, preempted, faulted or timed out) this
        tick."""
        self.stats.ticks += 1
        terminal = 0
        pool_blocked = False    # a PoolExhausted fired somewhere this tick
        tr = self.tracer
        tick_t0 = tr.now() if tr.enabled else 0.0
        # 0. injected tick delays (chaos): advances the shared logical
        #    clock, so deadline/timeout machinery feels the lost time
        if self.fault_injector is not None:
            self.fault_injector.on_tick()
        # 1. place waiting requests — priority-ordered, FIFO within a tier.
        #    Plain FIFO would hand a preemption-freed slot to the next
        #    lower-tier request in line, which stage 3 would immediately
        #    evict again for the same starving waiter: a cascade that
        #    destroys every queued lower-tier request ahead of one
        #    realtime arrival. Priority placement gives the slot to the
        #    waiter that justified the eviction.
        for qr in sorted(self.queue, key=lambda q: (q.priority, q.id)):
            if self.breaker is not None:
                # tripped VERIFY/serving head: re-route before placing (a
                # healthy stand-in beats waiting out the cooldown); tripped
                # DRAFT head: strip the draft, decode plain
                if qr.draft is not None and \
                        not self.breaker.allow(qr.draft):
                    if tr.enabled:
                        tr.instant("spec_degrade", "resilience", tid=qr.id,
                                   args={"draft": qr.draft})
                    qr.draft, qr.draft_len = None, 0
                    self.stats.record_spec_degraded()
                    self.fault_rids.add(qr.id)
                if not self.breaker.allow(qr.head or self._default_name()):
                    fallback = self._fallback_head(qr)
                    if fallback is not None and fallback != qr.head:
                        self.stats.record_fallback(qr.head, fallback)
                        if tr.enabled:
                            tr.instant("fallback", "resilience", tid=qr.id,
                                       args={"from": qr.head,
                                             "to": fallback})
                        self.fault_rids.add(qr.id)
                        qr.head = fallback
                        qr.cost = head_flops(self._catalog, fallback)
                        qr.draft, qr.draft_len = None, 0
                    else:
                        continue    # queued until the breaker half-opens
            sig = self._sig(qr)
            if self._retry_at.get(sig, 0) > self.stats.ticks:
                continue            # transient-fault backoff window
            stream = self._stream_for(qr)
            if stream is None:
                continue
            t0 = time.perf_counter()
            try:
                stream.join(qr.request, tag=qr)
            except HeadFault as e:
                # the guard fired BEFORE any stream state mutated (pages
                # rolled back, the generator's state restored), so the
                # request simply
                # stays queued: transient faults back off and retry,
                # anything else re-routes or terminates typed
                self.stats.record_fault(e.kind, e.transient)
                self.fault_rids.add(qr.id)
                if tr.enabled:
                    tr.instant("fault", "resilience", tid=qr.id,
                               args={"head": e.head, "kind": e.kind,
                                     "transient": e.transient})
                if self.breaker is not None:
                    self.breaker.record_failure(e.head, kind=e.kind,
                                                hard=not e.transient)
                tripped = self.breaker is not None and \
                    self.breaker.state(e.head) == OPEN
                if e.transient and not tripped and \
                        qr.retries < self.max_retries:
                    qr.retries += 1
                    self.stats.record_retry()
                    self._retry_at[sig] = self.stats.ticks + min(
                        2 ** (qr.retries - 1), 8)
                    if tr.enabled:
                        tr.instant("retry", "resilience", tid=qr.id,
                                   args={"head": e.head,
                                         "attempt": qr.retries})
                else:
                    self.queue.remove(qr)
                    terminal += self._redispatch(qr, e.head)
                continue
            except PoolExhausted as e:
                # join rolled back every page it took; the request stays
                # queued and stage 3 applies pool pressure. With nothing
                # in flight there is nothing left to preempt and the radix
                # cache already reclaimed all it could inside alloc — the
                # request can NEVER place, so it terminates typed instead
                # of stalling drain()
                pool_blocked = True
                if not self._inflight:
                    self.queue.remove(qr)
                    self._results[qr.id] = AdmissionRejected(
                        request=qr.request, stage="placement",
                        head=stream.head_name, reason=str(e))
                    self.stats.preempted += 1
                    terminal += 1
                    self._trace_terminal(qr.id, "preempted",
                                         head=stream.head_name)
                continue
            dt = time.perf_counter() - t0
            self.queue.remove(qr)
            self._retry_at.pop(sig, None)
            now = self.clock()
            qr.placed_at = now
            self._inflight[qr.id] = qr
            self.stats.record_queue_wait(now - qr.arrival)
            self.stats.record_decode(stream.head_name, 1, dt)  # first token
            if tr.enabled:
                tr.span("queue.wait", "queue", qr.arrival, now, tid=qr.id)
                tr.instant("join", "queue", tid=qr.id,
                           args={"head": stream.head_name,
                                 "join_s": dt})
        # 2. advance streams, retire finished sequences. A spec stream's
        #    tick is a whole draft/verify ROUND: it emits a VARIABLE number
        #    of tokens (1..draft_len per slot), so its token credit is the
        #    emitted-counter delta, not n_active, and the same delta feeds
        #    the server-wide speculative telemetry.
        for sig, stream in list(self._streams.items()):
            spec_before = stream.spec_counters() \
                if hasattr(stream, "spec_counters") else None
            skip = self._retry_at.get(sig, 0) > self.stats.ticks
            if not skip and stream.n_active and \
                    self.fault_injector is not None:
                # injected stall: the stream makes no progress this tick —
                # from the outside exactly what a hung device looks like;
                # the watchdog is what DETECTS it
                skip = any(self.fault_injector.stalled(h)
                           for h in self._stream_heads(stream))
            if stream.n_active and not skip:
                n_tok = stream.n_active
                t0 = time.perf_counter()
                try:
                    finished = stream.step()
                except PoolExhausted:
                    # nothing advanced or was consumed; completions from
                    # earlier joins still surface, stage 3 frees pages,
                    # and the next tick retries the identical step
                    pool_blocked = True
                    finished = stream.pop_finished()
                except HeadFault as e:
                    # the stream rolled the step back: retry with backoff,
                    # or offload + re-route (full page rollback)
                    terminal += self._on_stream_fault(sig, stream, e)
                    finished = stream.pop_finished()
                else:
                    dt = time.perf_counter() - t0
                    self._fail_count.pop(sig, None)
                    if self.breaker is not None:
                        for h in self._stream_heads(stream):
                            self.breaker.record_success(h)
                        if self.breaker.latency_spike_s is not None:
                            self.breaker.record_latency(stream.head_name,
                                                        dt)
                    if spec_before is not None:
                        after = stream.spec_counters()
                        delta = {k: after[k] - spec_before[k]
                                 for k in after}
                        self.stats.record_spec(**delta)
                        n_tok = delta["emitted"]
                    self.stats.record_decode(stream.head_name, n_tok, dt)
            else:
                finished = stream.pop_finished()
            for qr, request, tokens in finished:
                now = self.clock()
                self._results[qr.id] = ServeResult(
                    tokens=tokens, head=stream.head_name, request=request,
                    group_size=stream.width)
                self._inflight.pop(qr.id, None)
                if self.watchdog is not None:
                    self.watchdog.forget(qr.id)
                self.stats.record_completion(
                    stream.head_name, now - qr.arrival,
                    on_time=now <= qr.deadline)
                terminal += 1
                self._trace_terminal(qr.id, "completed",
                                     head=stream.head_name,
                                     n_tokens=len(tokens))
        # 3. preempt for starving waiters. A victim must be STRICTLY lower
        #    tier than the waiter and expendable — past its deadline, or
        #    best-effort work that never had one (the "batch" tier's inf
        #    deadline means "no completion promise", not "immune"). And the
        #    eviction must actually help THIS waiter: either the victim sits
        #    in the waiter's own stream (pad slot reusable next tick), or
        #    the waiter needs a new lane and the eviction idles one for
        #    recycling. At most one eviction per waiter per tick.
        now = self.clock()
        lane_freed_for: set = set()         # sigs a new lane was idled for
        for qr in self.queue:               # still queued = blocked this tick
            sig = self._sig(qr)
            own = self._streams.get(sig)
            if own is not None and own.free_slots:
                continue                    # placeable next tick as-is
            if own is None and sig in lane_freed_for:
                continue                    # this tick's eviction already
                                            # idles a lane for this signature
            # most expendable eligible victim across the lanes that help:
            # lowest tier first (highest priority value) — deadline-less
            # batch work yields before merely-late standard work
            best = None                     # (priority, slot, tag, stream)
            for cand in self._streams.values():
                if own is not None:
                    if cand is not own:
                        continue            # only its own lane's slots help
                elif cand.n_active != 1:
                    continue                # eviction must idle the lane
                for slot, tag in cand.occupied():
                    if tag.priority > qr.priority and \
                            (now > tag.deadline or math.isinf(tag.deadline)) \
                            and (best is None or tag.priority > best[0]):
                        best = (tag.priority, slot, tag, cand)
            if best is None:
                continue
            _, slot, tag, victim_stream = best
            _, request, partial = victim_stream.evict(slot)
            self._results[tag.id] = AdmissionRejected(
                request=request, stage="preempt",
                head=victim_stream.head_name, tokens=partial,
                reason=f"preempted: {tag.tier} work (deadline "
                       f"{tag.deadline:.3f}, now {now:.3f}) displaced "
                       f"by waiting {qr.tier} traffic")
            self._inflight.pop(tag.id, None)
            self.stats.preempted += 1
            terminal += 1
            self._trace_terminal(tag.id, "preempted",
                                 head=victim_stream.head_name)
            if own is None:
                lane_freed_for.add(sig)
        # 3b. POOL pressure: a PoolExhausted this tick means page capacity —
        #     not slots — is the bottleneck, and evicting ANY running slot
        #     helps (its whole page chain releases). Victim choice: prefer
        #     expendable work (past deadline, or deadline-less batch),
        #     lowest tier first; when the tick's waiters have a tier,
        #     victims must sit strictly below the most urgent one. Two
        #     consecutive stalled ticks ESCALATE: the deadline and tier
        #     guards drop, and the globally lowest-tier slot is evicted —
        #     pages must come from somewhere or the server livelocks.
        if pool_blocked:
            self._pool_stalled_ticks += 1
            force = self._pool_stalled_ticks >= 2
            waiter_pri = min((q.priority for q in self.queue), default=None)
            best = None                  # (not expendable, -priority) min-key
            for cand in self._streams.values():
                for slot, tag in cand.occupied():
                    expendable = now > tag.deadline or math.isinf(tag.deadline)
                    if not expendable and not force:
                        continue
                    if waiter_pri is not None and not force \
                            and tag.priority <= waiter_pri:
                        continue
                    key = (not expendable, -tag.priority)
                    if best is None or key < best[0]:
                        best = (key, slot, tag, cand)
            if best is not None:
                _, slot, tag, victim_stream = best
                _, request, partial = victim_stream.evict(slot)
                self._results[tag.id] = AdmissionRejected(
                    request=request, stage="preempt",
                    head=victim_stream.head_name, tokens=partial,
                    reason=f"pool exhausted: {tag.tier} work evicted to "
                           f"free its KV pages (stalled "
                           f"{self._pool_stalled_ticks} tick(s))")
                self._inflight.pop(tag.id, None)
                self.stats.preempted += 1
                terminal += 1
                self._trace_terminal(tag.id, "preempted",
                                     head=victim_stream.head_name)
                self._pool_stalled_ticks = 0
        else:
            self._pool_stalled_ticks = 0
        # 4. watchdog + per-request timeouts, on stage 3's ``now`` (no
        #    extra clock reads — a fake-clock test ticks identically
        #    whether or not resilience is wired)
        if self.watchdog is not None and self.watchdog.armed:
            for stream in self._streams.values():
                for slot, tag in stream.occupied():
                    self.watchdog.observe(
                        tag.id, len(stream.slots[slot].tokens), now)
            for rid in self.watchdog.stalled(now):
                qr = self._inflight.get(rid)
                found = self._find_slot(rid)
                if qr is None or found is None:
                    self.watchdog.forget(rid)
                    continue
                stream, slot = found
                _, _, partial = stream.evict(slot)
                self.stats.record_stall()
                head = stream.head_name
                if tr.enabled:
                    tr.instant("stall", "resilience", tid=rid,
                               args={"head": head})
                if self.breaker is not None:
                    self.breaker.record_failure(head, kind="stall")
                terminal += self._redispatch(qr, head, partial=partial)
        timed_out = [qr for qr in self._inflight.values()
                     if qr.request.timeout_s is not None
                     and now - qr.arrival > qr.request.timeout_s]
        for qr in timed_out:
            found = self._find_slot(qr.id)
            partial = None
            head = qr.head
            if found is not None:
                stream, slot = found
                _, _, partial = stream.evict(slot)
                head = stream.head_name
            self._inflight.pop(qr.id, None)
            if self.watchdog is not None:
                self.watchdog.forget(qr.id)
            self._results[qr.id] = AdmissionRejected(
                request=qr.request, stage="timeout", head=head,
                tokens=partial,
                reason=f"timeout_s={qr.request.timeout_s} elapsed "
                       f"({now - qr.arrival:.3f}s since submission)")
            self.stats.record_timeout()
            terminal += 1
            self._trace_terminal(qr.id, "timed_out", head=head)
        for qr in list(self.queue):
            if qr.request.timeout_s is not None \
                    and now - qr.arrival > qr.request.timeout_s:
                self.queue.remove(qr)
                self._results[qr.id] = AdmissionRejected(
                    request=qr.request, stage="timeout", head=qr.head,
                    reason=f"timeout_s={qr.request.timeout_s} elapsed "
                           f"while queued")
                self.stats.record_timeout()
                terminal += 1
                self._trace_terminal(qr.id, "timed_out", head=qr.head)
        if self.kv_pool is not None:
            self.stats.observe_pool(self.kv_pool.telemetry(),
                                    stalled=pool_blocked)
        self.stats.observe_queue(len(self.queue))
        if tr.enabled:
            tr.span("tick", "scheduler", tick_t0,
                    args={"tick": self.stats.ticks, "terminal": terminal,
                          "queued": len(self.queue),
                          "inflight": len(self._inflight)})
        return terminal

    def _find_slot(self, rid: int):
        """(stream, slot) currently decoding result id ``rid``, or None."""
        for stream in self._streams.values():
            for slot, tag in stream.occupied():
                if tag.id == rid:
                    return stream, slot
        return None

    # -- draining ------------------------------------------------------------
    @property
    def busy(self) -> bool:
        return bool(len(self.queue)) or any(
            not s.idle for s in self._streams.values())

    def _stuck_rids(self) -> List[int]:
        return sorted({qr.id for qr in self.queue}
                      | set(self._inflight.keys()))

    def drain(self, max_ticks: Optional[int] = None) -> List[object]:
        """Tick until queue and streams are empty; results in submission
        order (``ServeResult`` | ``AdmissionRejected``). Raises typed
        ``SchedulerStalled`` — carrying the stuck request ids and a final
        stats snapshot — when nothing progresses for several ticks or the
        ``max_ticks`` safety valve fires: a wedged server surfaces as a
        diagnosable error, never an infinite loop."""
        ticks = 0
        stalled = 0
        while self.busy:
            before = len(self._results)
            tok0 = self.stats.tokens
            pool0 = self.stats.pool_stalled_ticks
            self.step()
            ticks += 1
            # REAL progress is tokens decoded or results produced — a
            # stream full of occupied-but-frozen slots (an injected stall,
            # a wedged device) must not read as healthy. States that
            # legitimately idle a tick are PATIENCE, each bounded by a
            # mechanism that eventually produces progress or a typed
            # result: a transient-fault backoff window, a pool-pressure
            # tick (stage 3b escalates to a forced eviction), an open
            # breaker a queued request waits out (cooldown → half-open
            # probe), and an armed watchdog over in-flight work (its
            # stall timeout evicts to fallback/typed-reject).
            backing_off = any(t > self.stats.ticks
                              for t in self._retry_at.values())
            waiting = backing_off \
                or self.stats.pool_stalled_ticks > pool0 \
                or (self.breaker is not None and len(self.queue) > 0
                    and bool(self.breaker.open_heads())) \
                or (self.watchdog is not None and self.watchdog.armed
                    and bool(self._inflight))
            progressed = len(self._results) > before \
                or self.stats.tokens > tok0
            stalled = 0 if progressed or waiting else stalled + 1
            if stalled > 2:
                raise SchedulerStalled(
                    f"scheduler stalled: {len(self.queue)} queued + "
                    f"{len(self._inflight)} in-flight request(s) made no "
                    f"progress for {stalled} ticks "
                    f"(max_streams={self.max_streams} busy with other "
                    f"signatures, nothing preemptable, or every fallback "
                    f"head tripped)", rids=self._stuck_rids(),
                    stats=self.stats.snapshot())
            if max_ticks is not None and ticks >= max_ticks and self.busy:
                raise SchedulerStalled(
                    f"drain exceeded max_ticks={max_ticks} with "
                    f"{len(self.queue)} queued + {len(self._inflight)} "
                    f"in-flight request(s) outstanding",
                    rids=self._stuck_rids(), stats=self.stats.snapshot())
        return self.results()

    def results(self) -> List[object]:
        """Terminal results so far, submission order, in-flight skipped.
        NON-consuming: retains history, right for batch-style serve/drain
        use. A long-lived server loop should call ``pop_results()``."""
        return [self._results[r] for r in self._order if r in self._results]

    def pop_results(self) -> List[object]:
        """Terminal results so far in submission order, CONSUMED — the
        scheduler forgets them, so a server loop calling this each tick
        holds memory proportional to in-flight work, not to every token
        array ever served. In-flight submissions keep their place and
        surface in a later call."""
        out, rest = [], []
        for rid in self._order:
            if rid in self._results:
                out.append(self._results.pop(rid))
            else:
                rest.append(rid)
        self._order = rest
        return out

    def serve(self, requests: Sequence[ServeRequest]) -> List[object]:
        """Submit everything, drain, return results in request order — the
        continuous-batching counterpart of ``engine.serve_batch``."""
        for r in requests:
            self.submit(r)
        return self.drain()
