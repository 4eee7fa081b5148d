"""The port's observability and serving telemetry against the JAX
package's, on the CPU, each driven by the same calls on both:

  * ``Tracer``: the ring buffer (bounds, ``dropped``), the Chrome trace
    document (µs scaling, lanes, thread names, clamped durations) and the
    JSONL export are equal to the reference's; ``NULL_TRACER`` is inert;
  * ``MetricsRegistry``: counters, gauges and histograms, their errors,
    collectors, the Prometheus text and the JSON snapshot are equal;
  * ``ServerStats``: the same record calls give the reference's snapshot
    (every key, ``pool`` and ``spec`` included) and exposition;
  * ``LatencyTracker`` and ``Timer`` (``utils/timing.py``);
  * the scheduler's request-lifecycle spans: a traced drain through the
    port's scheduler leaves the reference's events (names, lanes, args,
    timestamps on the shared fake clock), with one submit→retire
    "request" span per request, for completed and rejected requests.
"""
import json
import math

import numpy as np
import pytest

from repro.serving import BudgetAdmission as JBudget
from repro.serving import ContinuousScheduler as JSched
from repro.serving import DecodeEngine as JEngine
from repro.serving import ServeRequest as JRequest
from repro.serving import TierPolicy as JTier
from repro.serving.observe import MetricsRegistry as JRegistry
from repro.serving.observe import NULL_TRACER as J_NULL
from repro.serving.observe import Tracer as JTracer
from repro.serving.scheduler import ServerStats as JStats
from repro.utils.timing import LatencyTracker as JTracker
from repro_torch.serving import (NULL_TRACER, BudgetAdmission,
                                 ContinuousScheduler, DecodeEngine,
                                 LogicalClock, MetricsRegistry, NullTracer,
                                 ServeRequest, TierPolicy, Tracer)
from repro_torch.serving.observe import SCHED_TID
from repro_torch.serving.scheduler import ServerStats
from repro_torch.utils.timing import LatencyTracker, Timer, bench_wall
from torch_serving_fixtures import TWIN, lstm_fx, prompts


@pytest.fixture(scope="module")
def lstm():
    return lstm_fx()


def _nan_safe(x):
    """NaN → a marker, so snapshots compare with ==."""
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, dict):
        return {k: _nan_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_nan_safe(v) for v in x]
    return x


def test_tracer_equals_the_reference(tmp_path):
    def drive(cls, tag):
        clk = LogicalClock()
        out = []
        tr = cls(clock=clk, capacity=4)
        for i in range(6):
            tr.instant(f"ev{i}", "test")
        out += [tr.emitted, tr.dropped, [e["name"] for e in tr.events()]]
        tr.clear()
        out += [tr.emitted, tr.events()]
        tr = cls(clock=clk)
        clk.t = 1.0
        tr.instant("submit", "request", tid=7, args={"tier": "realtime"})
        tr.span("request", "request", 1.0, 3.5, tid=7, args={"outcome": 1})
        tr.span("tick", "scheduler", 0.5, 2.0)
        tr.span("bad", "test", 5.0, 4.0)              # clamped to 0
        out.append(tr.chrome_trace())
        tr.export_chrome(str(tmp_path / f"{tag}.json"))
        tr.export_jsonl(str(tmp_path / f"{tag}.jsonl"))
        with open(tmp_path / f"{tag}.json") as f:
            out.append(json.load(f))
        with open(tmp_path / f"{tag}.jsonl") as f:
            out.append([json.loads(ln) for ln in f])
        return out
    got, want = drive(Tracer, "port"), drive(JTracer, "ref")
    assert got == want
    doc = got[-3]
    names = {m["tid"]: m["args"]["name"] for m in doc["traceEvents"]
             if m["ph"] == "M"}
    assert names[SCHED_TID] == "scheduler" and names[7] == "request 7"
    span = next(e for e in doc["traceEvents"] if e["name"] == "request")
    assert span["ts"] == pytest.approx(1.0e6)
    assert span["dur"] == pytest.approx(2.5e6)
    assert isinstance(NULL_TRACER, NullTracer) and not NULL_TRACER.enabled
    NULL_TRACER.span("x", "y", 0.0)
    NULL_TRACER.instant("x", "y")
    assert NULL_TRACER.events() == [] and NULL_TRACER.dropped == 0
    assert NULL_TRACER.chrome_trace() == J_NULL.chrome_trace()


def test_metrics_registry_equals_the_reference():
    def drive(cls):
        out = []
        reg = cls()
        c = reg.counter("reqs_total", "requests", ("event",))
        c.inc(2, event="ok")
        c.inc(event="ok")
        out.append(c.value(event="ok"))
        c.set_monotonic(7, event="ok")
        for bad in (lambda: c.inc(-1, event="ok"),
                    lambda: c.set_monotonic(5, event="ok"),
                    lambda: c.inc(1, evnt="typo"), lambda: c.inc(1),
                    lambda: reg.gauge("reqs_total", labelnames=("event",)),
                    lambda: reg.counter("reqs_total", labelnames=("h",)),
                    lambda: reg.histogram("h0", buckets=())):
            with pytest.raises(ValueError) as ei:
                bad()
            out.append(str(ei.value))
        h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 0.5, 5.0, float("nan")):
            h.observe(v)
        out += [h.count(), h.sum()]
        g = reg.gauge("depth")
        g.set(3)
        g.inc()
        g.dec(2)
        out.append(g.value())
        calls = []
        reg.register_collector(lambda: calls.append(1))
        out += [reg.prometheus_text(), reg.snapshot(), len(calls),
                reg.get("nope")]
        return out
    got, want = drive(MetricsRegistry), drive(JRegistry)
    assert got == want
    assert 'lat_seconds_bucket{le="1"} 3' in got[-4]


def _record(st):
    st.submitted += 3
    st.admitted += 2
    st.rejected += 1
    st.downgraded += 1
    st.ticks += 4
    st.record_decode("exact", 5, 0.25)
    st.record_decode("screened", 3, 0.125)
    st.record_completion("exact", latency_s=0.2, on_time=True)
    st.record_completion("screened", latency_s=2.0, on_time=False)
    st.record_queue_wait(0.01)
    st.observe_queue(3)
    st.observe_queue(1)
    st.record_fault("transient", transient=True)
    st.record_fault("permanent", transient=False)
    st.record_retry()
    st.record_fallback("screened", "exact")
    st.record_faulted()
    st.record_timeout()
    st.record_stall()
    st.record_breaker("exact", "closed", "open")
    st.record_breaker("exact", "open", "half-open")
    st.record_breaker("exact", "half-open", "closed")


def test_server_stats_snapshot_and_mirror_equal_the_reference():
    empty, jempty = ServerStats().snapshot(), JStats().snapshot()
    assert set(empty) == set(jempty)
    assert _nan_safe(empty) == _nan_safe(jempty)
    assert empty["pool"] is None and empty["spec"] is None
    st, jst = ServerStats(), JStats()
    _record(st)
    _record(jst)
    snap, jsnap = st.snapshot(), jst.snapshot()
    assert set(snap) == set(jsnap)
    assert _nan_safe(snap) == _nan_safe(jsnap)
    assert set(snap["resilience"]) == set(jsnap["resilience"])
    assert st.metrics.prometheus_text() == jst.metrics.prometheus_text()
    assert _nan_safe(st.metrics.snapshot()) == \
        _nan_safe(jst.metrics.snapshot())
    snap["per_head"]["exact"]["tokens"] = 999       # a defensive copy
    assert st.snapshot()["per_head"]["exact"]["tokens"] == 5


def test_latency_tracker_and_timer_equal_the_reference():
    rng = np.random.default_rng(0)
    xs = rng.random(50)
    for cls in (LatencyTracker, JTracker):
        with pytest.raises(ValueError):
            cls(window=0)
    t, j = LatencyTracker(window=16), JTracker(window=16)
    assert _nan_safe(t.snapshot()) == _nan_safe(j.snapshot())
    for x in xs:
        t.record(x)
        j.record(x)
    assert t.snapshot() == j.snapshot() and len(t) == len(j) == 16
    assert t.percentile(90.0) == j.percentile(90.0)
    with pytest.raises(ValueError):
        t.percentile(101.0)
    with Timer() as tm:
        sum(range(1000))
    assert tm.s >= 0 and tm.ms == tm.s * 1e3
    assert bench_wall(lambda: np.zeros(3), warmup=1, iters=3) >= 0


def test_scheduler_lifecycle_spans_equal_the_reference(lstm):
    """A traced drain of 6 requests (one rejected by the budget) through
    ``screened-cuda`` and ``exact``: the port's events equal the
    reference's (heads named as in each package; the join's wall time
    aside), every request has one terminal span on its own lane, and the
    kernel spans name the heads."""
    ps = prompts(lstm, 6, 7, seed=31)
    events = []
    for eng, sched_cls, req, pol, adm, tracer in (
            (DecodeEngine(lstm["tmodel"], lstm["tparams"],
                          screen=lstm["tscreen"], max_len=30, device="cpu"),
             ContinuousScheduler, ServeRequest,
             TierPolicy({"realtime": "screened-cuda"}, default="exact"),
             BudgetAdmission, Tracer),
            (JEngine(lstm["jmodel"], lstm["jparams"], screen=lstm["jscreen"],
                     max_len=30),
             JSched, JRequest,
             JTier({"realtime": "screened-pallas"}, default="exact"),
             JBudget, JTracer)):
        flops = eng.head_catalog(["exact"])["exact"]["flops_per_query"]
        clk = LogicalClock(dt_per_read=1e-4)
        tr = tracer(clock=clk)
        sched = sched_cls(eng, policy=pol, max_slots=2, clock=clk, tracer=tr,
                          admission=adm(flops_budget=4.5 * flops))
        out = sched.serve([req(prompt=p, max_new=3,
                               latency_tier=("realtime", "standard")[i % 2])
                           for i, p in enumerate(ps)])
        evs = []
        for e in tr.events():
            e = dict(e)
            args = dict(e.get("args", {}))
            args.pop("join_s", None)
            for k in ("head", "from", "to"):
                if k in args:
                    args[k] = TWIN.get(args[k], args[k])
            e["args"] = args
            evs.append(e)
        events.append((evs, [type(r).__name__ for r in out]))
    assert events[0] == events[1]
    evs, kinds = events[0]
    assert "AdmissionRejected" in kinds and "ServeResult" in kinds
    spans = [e for e in evs if e["name"] == "request"]
    assert sorted(s["tid"] for s in spans) == list(range(6))
    assert {s["args"]["outcome"] for s in spans} == {"completed", "rejected"}
    ticks = [e for e in evs if e["name"] == "tick"]
    assert ticks and all(e["tid"] == SCHED_TID for e in ticks)
    kern = [e for e in evs if e["name"] == "kernel.step"]
    assert {e["args"]["head"] for e in kern} == {"screened-pallas", "exact"}
