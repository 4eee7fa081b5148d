"""Live serving telemetry for the continuous-batching scheduler. Twin of
``repro/serving/scheduler/stats.py``, kept as the port's own copy.

``ServerStats`` is the one object every serving surface reads: the
scheduler updates it in place each tick, ``launch/serve.py --scheduler``
prints it, and ``chip_smoke.py`` prints ``snapshot()``. The ``pool`` and
``spec`` sections are ``None`` until a scheduler with a ``kv_pool`` or a
``spec`` policy feeds them.

Two clocks feed it, deliberately: arrival/deadline/latency quantities come
from the scheduler's INJECTABLE clock (deterministic under test / simulated
time), while per-head throughput is always measured on the real
``time.perf_counter`` wall — tokens/s against a fake clock would be
fiction.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, Optional

from repro_torch.serving.observe.metrics import MetricsRegistry
from repro_torch.utils.timing import LatencyTracker


class ServerStats:
    """Counters + sliding-window latency percentiles for one scheduler.

    Admission funnel: ``submitted = admitted + rejected`` (downgrades are
    admitted; ``downgraded`` counts how many of those were rerouted).
    Completion funnel: every admitted request ends ``completed``,
    ``preempted``, ``faulted`` or ``timed_out``. ``latency`` tracks submission→last-token seconds for
    completed requests; ``queue_wait`` tracks submission→slot seconds for
    everything that got a slot."""

    def __init__(self, latency_window: int = 4096):
        self.submitted = 0
        self.admitted = 0
        self.rejected = 0
        self.downgraded = 0
        self.preempted = 0
        self.completed = 0
        self.ticks = 0
        self.tokens = 0
        self.queue_depth = 0
        self.max_queue_depth = 0
        self.deadline_met = 0
        self.deadline_missed = 0
        self.latency = LatencyTracker(latency_window)
        self.queue_wait = LatencyTracker(latency_window)
        # name -> {"requests", "tokens", "decode_s"}; tokens/s derived in
        # snapshot() so the accumulators stay mergeable
        self.per_head: Dict[str, Dict[str, float]] = {}
        # paged KV pool utilization (None until a paged scheduler feeds it):
        # last PagePool.telemetry() snapshot + per-tick COW deltas
        self.pool: Optional[Dict[str, object]] = None
        self.pool_stalled_ticks = 0      # ticks a PoolExhausted blocked work
        self._pool_cow_seen = 0
        self._pool_cow_ticks = 0
        self._pool_cow_total = 0
        # speculative decoding (repro_torch.serving.spec): draft/verify round
        # accounting fed by the scheduler's per-tick spec_counters() deltas.
        # All zero until a spec stream runs.
        self.spec_rounds = 0             # per-slot draft/verify rounds
        self.spec_draft_steps = 0        # trunk decode steps spent drafting
        self.spec_drafted = 0            # tokens proposed by draft heads
        self.spec_accepted = 0           # drafted tokens the verifier kept
        self.spec_emitted = 0            # tokens emitted by spec streams
        self.spec_verify_queries = 0     # verify-head queries (padded n_max·W)
        self.spec_verify_flops = 0.0     # modeled flops of those queries
        # resilience funnel (repro_torch.serving.resilience): all zero until a
        # fault, retry, breaker transition, stall or timeout happens. Every
        # faulted request still ends completed / preempted / faulted /
        # timed_out — the funnel stays closed under chaos.
        self.faults_transient = 0        # retryable HeadFaults absorbed
        self.faults_permanent = 0        # hard HeadFaults (immediate re-route)
        self.fault_kinds: Dict[str, int] = {}
        self.retries = 0                 # bounded-backoff retry attempts
        self.fallbacks = 0               # requests re-routed off a sick head
        self.faulted = 0                 # requests terminated stage="fault"
        self.timed_out = 0               # requests terminated stage="timeout"
        self.watchdog_stalls = 0         # stalled streams the watchdog caught
        self.spec_degraded = 0           # spec requests stripped to plain
        self.breaker_trips = 0           # closed/half-open -> open
        self.breaker_half_opens = 0      # open -> half-open (cooldown probe)
        self.breaker_closes = 0          # half-open -> closed (recovery)
        self.breaker_states: Dict[str, str] = {}
        # bounded transition log: (tick, head, old, new), newest last
        self.breaker_transitions = []
        self._resilience_touched = False
        # typed-metrics mirror: the plain attributes above stay the source
        # of truth (and the snapshot() contract); a registered collector
        # refreshes the registry from them at every exposition, while the
        # two latency histograms are push-fed (a histogram can't be rebuilt
        # from a sliding window after the fact)
        self.metrics = MetricsRegistry()
        self._hist_latency = self.metrics.histogram(
            "serve_request_latency_seconds",
            "submission -> last-token seconds for completed requests")
        self._hist_queue_wait = self.metrics.histogram(
            "serve_queue_wait_seconds",
            "submission -> slot seconds for requests that got a slot")
        self.metrics.register_collector(self._collect_metrics)

    # -- update hooks (called by ContinuousScheduler) ------------------------
    def _head(self, name: str) -> Dict[str, float]:
        return self.per_head.setdefault(
            name, {"requests": 0, "tokens": 0, "decode_s": 0.0})

    def record_decode(self, head: str, n_tokens: int, seconds: float) -> None:
        """One decode tick (or join prefill) on ``head``: ``n_tokens``
        tokens materialized in ``seconds`` of real wall time."""
        d = self._head(head)
        d["tokens"] += int(n_tokens)
        d["decode_s"] += float(seconds)
        self.tokens += int(n_tokens)

    def record_completion(self, head: str, latency_s: float,
                          on_time: bool) -> None:
        self.completed += 1
        self._head(head)["requests"] += 1
        self.latency.record(latency_s)
        self._hist_latency.observe(latency_s)
        if on_time:
            self.deadline_met += 1
        else:
            self.deadline_missed += 1

    def record_queue_wait(self, seconds: float) -> None:
        """Submission -> slot wait for one request that got a slot."""
        self.queue_wait.record(seconds)
        self._hist_queue_wait.observe(seconds)

    def record_spec(self, rounds: int, draft_steps: int, drafted: int,
                    accepted: int, emitted: int, verify_queries: int,
                    verify_flops: float) -> None:
        """One tick's speculative-decode delta (a round may emit several
        tokens; ``record_decode`` separately credits those tokens to the
        stream's composite head name)."""
        self.spec_rounds += int(rounds)
        self.spec_draft_steps += int(draft_steps)
        self.spec_drafted += int(drafted)
        self.spec_accepted += int(accepted)
        self.spec_emitted += int(emitted)
        self.spec_verify_queries += int(verify_queries)
        self.spec_verify_flops += float(verify_flops)

    def record_fault(self, kind: str, transient: bool) -> None:
        """One typed ``HeadFault`` the scheduler absorbed."""
        self._resilience_touched = True
        if transient:
            self.faults_transient += 1
        else:
            self.faults_permanent += 1
        self.fault_kinds[kind] = self.fault_kinds.get(kind, 0) + 1

    def record_retry(self) -> None:
        self._resilience_touched = True
        self.retries += 1

    def record_fallback(self, frm: Optional[str], to: Optional[str]) -> None:
        """One request re-routed off a faulting/tripped head."""
        self._resilience_touched = True
        self.fallbacks += 1

    def record_faulted(self) -> None:
        """One request terminated ``stage="fault"`` (retries + fallbacks
        exhausted)."""
        self._resilience_touched = True
        self.faulted += 1

    def record_timeout(self) -> None:
        """One request terminated ``stage="timeout"``."""
        self._resilience_touched = True
        self.timed_out += 1

    def record_stall(self) -> None:
        """One stalled stream/request the watchdog caught."""
        self._resilience_touched = True
        self.watchdog_stalls += 1

    def record_spec_degraded(self) -> None:
        """One spec request stripped of its draft (degraded to plain)."""
        self._resilience_touched = True
        self.spec_degraded += 1

    def record_breaker(self, head: str, old: str, new: str,
                       keep: int = 64) -> None:
        """One circuit-breaker transition (the breaker's ``on_transition``
        hook). The transition log is bounded at ``keep`` entries."""
        self._resilience_touched = True
        if new == "open":
            self.breaker_trips += 1
        elif new == "half-open":
            self.breaker_half_opens += 1
        elif old == "half-open" and new == "closed":
            self.breaker_closes += 1
        self.breaker_states[head] = new
        self.breaker_transitions.append((self.ticks, head, old, new))
        if len(self.breaker_transitions) > keep:
            del self.breaker_transitions[:-keep]

    def observe_queue(self, depth: int) -> None:
        self.queue_depth = int(depth)
        self.max_queue_depth = max(self.max_queue_depth, self.queue_depth)

    def observe_pool(self, telemetry: dict, stalled: bool = False) -> None:
        """One tick's ``PagePool.telemetry()``: keeps the latest snapshot
        and accumulates the per-tick COW rate (cumulative counter deltas)."""
        cow = int(telemetry.get("cow_copies", 0))
        self._pool_cow_total += max(0, cow - self._pool_cow_seen)
        self._pool_cow_seen = cow
        self._pool_cow_ticks += 1
        self.pool = dict(telemetry)
        if stalled:
            self.pool_stalled_ticks += 1

    # -- metrics mirror ------------------------------------------------------
    #: breaker state -> serve_breaker_state gauge value
    _BREAKER_STATE_VALUE = {"closed": 0, "half-open": 1, "open": 2}

    def _collect_metrics(self) -> None:
        """Refresh the typed-metrics registry from the live attributes —
        the registered collector the registry runs before every
        ``prometheus_text()`` / ``metrics.snapshot()`` exposition."""
        m = self.metrics
        funnel = m.counter("serve_requests_total",
                           "admission/completion funnel events", ("event",))
        for event, v in (("submitted", self.submitted),
                         ("admitted", self.admitted),
                         ("rejected", self.rejected),
                         ("downgraded", self.downgraded),
                         ("preempted", self.preempted),
                         ("completed", self.completed),
                         ("faulted", self.faulted),
                         ("timed_out", self.timed_out)):
            funnel.set_monotonic(v, event=event)
        m.counter("serve_ticks_total",
                  "scheduler ticks").set_monotonic(self.ticks)
        m.counter("serve_tokens_total",
                  "tokens decoded").set_monotonic(self.tokens)
        m.gauge("serve_queue_depth",
                "requests waiting for a slot").set(self.queue_depth)
        deadline = m.counter("serve_deadline_total",
                             "deadline outcomes", ("outcome",))
        deadline.set_monotonic(self.deadline_met, outcome="met")
        deadline.set_monotonic(self.deadline_missed, outcome="missed")
        head_tok = m.counter("serve_head_tokens_total",
                             "tokens decoded per head", ("head",))
        head_req = m.counter("serve_head_requests_total",
                             "requests completed per head", ("head",))
        head_s = m.counter("serve_head_decode_seconds_total",
                           "wall decode seconds per head", ("head",))
        for name, d in self.per_head.items():
            head_tok.set_monotonic(d["tokens"], head=name)
            head_req.set_monotonic(d["requests"], head=name)
            head_s.set_monotonic(d["decode_s"], head=name)
        if self.spec_rounds:
            spec = m.counter("serve_spec_total",
                             "speculative-decode accounting", ("what",))
            for what, v in (("rounds", self.spec_rounds),
                            ("draft_steps", self.spec_draft_steps),
                            ("drafted", self.spec_drafted),
                            ("accepted", self.spec_accepted),
                            ("emitted", self.spec_emitted),
                            ("verify_queries", self.spec_verify_queries)):
                spec.set_monotonic(v, what=what)
        if self._resilience_touched:
            faults = m.counter("serve_faults_total",
                               "typed HeadFaults absorbed", ("kind",))
            for kind, v in self.fault_kinds.items():
                faults.set_monotonic(v, kind=kind)
            res = m.counter("serve_resilience_total",
                            "resilience funnel events", ("event",))
            for event, v in (("retries", self.retries),
                             ("fallbacks", self.fallbacks),
                             ("watchdog_stalls", self.watchdog_stalls),
                             ("spec_degraded", self.spec_degraded),
                             ("breaker_trips", self.breaker_trips),
                             ("breaker_half_opens", self.breaker_half_opens),
                             ("breaker_closes", self.breaker_closes)):
                res.set_monotonic(v, event=event)
            state = m.gauge("serve_breaker_state",
                            "0=closed, 1=half-open, 2=open", ("head",))
            for head, st in self.breaker_states.items():
                state.set(self._BREAKER_STATE_VALUE.get(st, -1), head=head)
        if self.pool is not None:
            pool = m.gauge("serve_pool_pages", "paged KV pool pages",
                           ("what",))
            for what in ("pages_in_use", "pages_free", "peak_pages_in_use"):
                pool.set(float(self.pool.get(what, 0)), what=what)
            m.counter("serve_pool_cow_copies_total",
                      "copy-on-write page copies").set_monotonic(
                float(self.pool.get("cow_copies", 0)))
            m.gauge("serve_pool_hbm_resident_bytes",
                    "HBM bytes held by resident pages").set(
                float(self.pool.get("hbm_resident_bytes", 0)))
            prefix = self.pool.get("prefix")
            if isinstance(prefix, dict):
                px = m.counter("serve_prefix_tokens_total",
                               "radix prefix-cache prompt tokens",
                               ("outcome",))
                hit = float(prefix.get("tokens_hit", 0))
                px.set_monotonic(hit, outcome="hit")
                px.set_monotonic(
                    max(0.0, float(prefix.get("tokens_total", 0)) - hit),
                    outcome="miss")

    # -- reporting -----------------------------------------------------------
    @property
    def reject_rate(self) -> float:
        return self.rejected / self.submitted if self.submitted else math.nan

    def snapshot(self) -> dict:
        """JSON-ready view of every counter.

        Every subtree is a fresh copy: callers stash snapshots, diff them
        across ticks and serialize them later, so handing out a live
        nested reference (the pool telemetry carries a nested ``prefix``
        dict) would let a caller's mutation corrupt — or a later tick
        retroactively rewrite — an already-taken snapshot."""
        per_head = {}
        for name, d in sorted(self.per_head.items()):
            s = d["decode_s"]
            per_head[name] = {
                "requests": int(d["requests"]), "tokens": int(d["tokens"]),
                "decode_s": s,
                "tokens_per_s": (d["tokens"] / s) if s > 0 else math.nan,
            }
        return {
            "submitted": self.submitted, "admitted": self.admitted,
            "rejected": self.rejected, "downgraded": self.downgraded,
            "preempted": self.preempted, "completed": self.completed,
            "ticks": self.ticks, "tokens": self.tokens,
            "queue_depth": self.queue_depth,
            "max_queue_depth": self.max_queue_depth,
            "deadline_met": self.deadline_met,
            "deadline_missed": self.deadline_missed,
            "reject_rate": self.reject_rate,
            "latency": self.latency.snapshot(),
            "queue_wait": self.queue_wait.snapshot(),
            "per_head": per_head,
            "spec": None if self.spec_rounds == 0 else {
                "rounds": self.spec_rounds,
                "draft_steps": self.spec_draft_steps,
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "emitted": self.spec_emitted,
                # the headline numbers: >1 means speculation is paying
                "accepted_tokens_per_step": (
                    self.spec_emitted / self.spec_rounds),
                "draft_acceptance": (
                    self.spec_accepted / self.spec_drafted
                    if self.spec_drafted else math.nan),
                "verify_queries": self.spec_verify_queries,
                "verify_flops": self.spec_verify_flops,
            },
            "resilience": None if not self._resilience_touched else {
                "faults_transient": self.faults_transient,
                "faults_permanent": self.faults_permanent,
                "fault_kinds": dict(sorted(self.fault_kinds.items())),
                "retries": self.retries,
                "fallbacks": self.fallbacks,
                "faulted": self.faulted,
                "timed_out": self.timed_out,
                "watchdog_stalls": self.watchdog_stalls,
                "spec_degraded": self.spec_degraded,
                "breaker_trips": self.breaker_trips,
                "breaker_half_opens": self.breaker_half_opens,
                "breaker_closes": self.breaker_closes,
                "breaker_states": dict(sorted(self.breaker_states.items())),
                "breaker_transitions": [
                    list(t) for t in self.breaker_transitions],
            },
            "pool": None if self.pool is None else {
                **copy.deepcopy(self.pool),
                "stalled_ticks": self.pool_stalled_ticks,
                "cow_copies_per_tick": (
                    self._pool_cow_total / self._pool_cow_ticks
                    if self._pool_cow_ticks else 0.0),
            },
        }

    def __repr__(self) -> str:     # pragma: no cover - debug aid
        return (f"ServerStats(submitted={self.submitted}, "
                f"completed={self.completed}, rejected={self.rejected}, "
                f"preempted={self.preempted}, tokens={self.tokens})")
