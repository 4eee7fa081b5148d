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
import torch
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


def _record_spec_and_pool(st):
    st.record_spec(rounds=4, draft_steps=6, drafted=20, accepted=13,
                   emitted=17, verify_queries=32, verify_flops=1.5e6)
    st.record_spec(rounds=2, draft_steps=3, drafted=6, accepted=2,
                   emitted=4, verify_queries=16, verify_flops=7.5e5)
    st.record_spec_degraded()
    tele = {"page_size": 4, "pages_total": 15, "pages_in_use": 6,
            "pages_free": 9, "peak_pages_in_use": 8, "cow_copies": 2,
            "bytes_per_page": 2048, "hbm_resident_bytes": 6 * 2048,
            "store_bytes": 0, "prefix": {"nodes": 4, "hit_rate": 0.5}}
    st.observe_pool(tele, stalled=True)
    st.observe_pool(dict(tele, cow_copies=5, pages_in_use=3), stalled=False)


def test_server_stats_spec_and_pool_fields_equal_the_reference():
    """``record_spec``, ``record_spec_degraded`` and ``observe_pool`` give
    the reference's ``spec`` and ``pool`` sections and exposition."""
    st, jst = ServerStats(), JStats()
    _record_spec_and_pool(st)
    _record_spec_and_pool(jst)
    snap, jsnap = st.snapshot(), jst.snapshot()
    assert _nan_safe(snap) == _nan_safe(jsnap)
    assert snap["spec"]["rounds"] == 6 and snap["spec"]["emitted"] == 21
    assert snap["pool"]["stalled_ticks"] == 1
    assert snap["pool"]["cow_copies_per_tick"] == 2.5
    assert snap["resilience"]["spec_degraded"] == 1
    assert st.metrics.prometheus_text() == jst.metrics.prometheus_text()


def test_scheduler_spec_gauges_equal_the_reference(lstm):
    """A drain on a spec lane leaves the reference's per-lane
    ``serve_spec_draft_len`` / ``serve_spec_draft_acceptance`` gauges."""
    from repro.serving import SpecPolicy as JSpecPolicy
    from repro.serving import StaticPolicy as JStatic
    from repro_torch.serving import SpecPolicy, StaticPolicy
    ps = prompts(lstm, 3, 6, seed=33)
    gauges = []
    for eng, sched_cls, req, static, pol in (
            (DecodeEngine(lstm["tmodel"], lstm["tparams"],
                          screen=lstm["tscreen"], max_len=30, device="cpu"),
             ContinuousScheduler, ServeRequest, StaticPolicy, SpecPolicy),
            (JEngine(lstm["jmodel"], lstm["jparams"], screen=lstm["jscreen"],
                     max_len=30), JSched, JRequest, JStatic, JSpecPolicy)):
        sched = sched_cls(eng, policy=static("exact"), max_slots=3,
                          spec=pol(drafts=("screened",), draft_len=4,
                                   min_ratio=1.0))
        for p in ps:
            sched.submit(req(prompt=p, max_new=7))
        while sched.busy:
            sched.step()
            snap = sched.stats.metrics.snapshot()
            gauges.append({k: v for k, v in snap.items()
                           if k.startswith("serve_spec_draft")})
    half = len(gauges) // 2
    assert gauges[:half] == gauges[half:]
    assert any(g.get("serve_spec_draft_len") for g in gauges)


# -- the cost-drift audit -------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """The reference's ``tests/test_observe.py`` recipe: reduced
    ptb-small-lstm trained 60 steps and a fitted screen, in JAX; the port's
    engine over the same weights and screen."""
    import jax
    import jax.numpy as jnp

    from repro.configs import L2SConfig, TrainConfig, get_config
    from repro.core import collect_contexts, fit_l2s
    from repro.data import ZipfMarkovCorpus, make_lm_batches
    from repro.launch.steps import make_train_step
    from repro.models import build_model
    from repro.optim import adamw_init
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.interop import params_from_numpy, screen_from_numpy
    from repro_torch.models import Model
    cfg = get_config("ptb-small-lstm").reduced()
    m = build_model(cfg)
    params = m.init(jax.random.key(0), dtype=jnp.float32)
    corpus = ZipfMarkovCorpus(cfg.vocab_size, branching=32, seed=3)
    tcfg = TrainConfig(lr=2e-3, total_steps=60, warmup_steps=5,
                       remat="none", loss_chunk=None)
    step = jax.jit(make_train_step(m, tcfg))
    opt = adamw_init(params)
    for batch in make_lm_batches(corpus, 60, 8, 32, seed=1):
        params, opt, _ = step(params, opt,
                              {k: jnp.asarray(v) for k, v in batch.items()})
    H, y = collect_contexts(
        m, params, [jnp.asarray(b["tokens"])
                    for b in make_lm_batches(corpus, 8, 8, 32, seed=9)],
        max_vectors=2000)
    st = fit_l2s(H, y, cfg.vocab_size,
                 L2SConfig(num_clusters=16, budget=64, outer_iters=1,
                           sgd_steps=50))
    kw = dict(rho=cfg.d_model, n_top=cfg.vocab_size)
    jeng = JEngine(m, params, screen=st.screen, max_len=36, head_kwargs=kw)
    s = st.screen
    teng = DecodeEngine(
        Model(t_get_config("ptb-small-lstm").reduced()),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params)),
        screen=screen_from_numpy(np.asarray(s.v), np.asarray(s.cand_idx),
                                 np.asarray(s.cand_len), s.vocab_size,
                                 s.block),
        max_len=36, device="cpu", head_kwargs=kw)
    return jeng, teng


DRIFT_NAMES = ("exact", "screened", "svd", "no-such-head")


def test_audit_cost_drift_equals_the_reference(trained):
    """The port's audit against the reference's on the same trained LSTM
    and screen: the same heads (unknown names skipped), ``predicted``
    equal, the exact head's op FLOPs within 100× of its model (a plain
    matmul: 2 flops a MAC, plus the top-k), as the reference's HLO FLOPs
    are, host heads timed and not counted, JSON-ready."""
    from repro.serving import audit_cost_drift as j_audit
    from repro_torch.serving import audit_cost_drift
    jeng, teng = trained
    want = j_audit(jeng, DRIFT_NAMES, iters=2, warmup=1)
    got = audit_cost_drift(teng, DRIFT_NAMES, iters=2, warmup=1)
    assert set(got) == set(want) == {"exact", "screened", "svd"}
    for name in got:
        assert _nan_safe(got[name]["predicted"]) == \
            _nan_safe(want[name]["predicted"]), name
        assert got[name]["measured"]["wall_s_per_query"] > 0
    r = got["exact"]["ratio"]["flops"]
    assert r is not None and math.isfinite(r) and 1e-2 < r < 1e2
    assert 1e-2 < want["exact"]["ratio"]["flops"] < 1e2
    assert got["exact"]["measured"]["op_flops"] > 0
    assert got["screened"]["ratio"]["bytes"] is not None
    assert "op_flops" not in got["svd"]["measured"]
    assert got["svd"]["ratio"] == {"flops": None, "bytes": None}
    assert json.loads(json.dumps(got))


def test_audit_cost_drift_counts_the_kernel_heads_and_skips_sharded(trained):
    """screened-cuda's count is its two kernels' records (route, fused top-k)
    plus the id gather between them; a sharded head is timed but not
    counted, as the reference's mesh heads are not; a head that fails is
    an ``error`` entry, not an exception."""
    from repro_torch import heads
    from repro_torch.launch.op_cost import count_cost
    from repro_torch.serving import audit_cost_drift
    _, teng = trained
    h = torch.zeros((1, teng.model.cfg.d_model))
    cuda = heads.get("screened-cuda", device="cpu", W=teng.W, b=teng.b,
                     screen=_block_screen(teng))
    _, c = count_cost(cuda.next, h)
    assert [r.name for r in c.ops if r.name in ("cluster_route",
            "fused_screened_topk")] == ["cluster_route", "fused_screened_topk"]
    teng._head_cache["broken"] = _Broken()
    got = audit_cost_drift(teng, ("exact-sharded", "broken"), iters=1,
                           warmup=0)
    assert "op_flops" not in got["exact-sharded"]["measured"]
    assert got["exact-sharded"]["measured"]["wall_s_per_query"] > 0
    assert got["broken"]["error"].startswith("RuntimeError")
    del teng._head_cache["broken"]


class _Broken:
    is_jittable = True
    n_shards = None

    def describe(self):
        raise RuntimeError("no describe")


def _block_screen(teng):
    """A 128-word block screen over the engine's vocabulary (one cluster
    holding every block), for the kernel head."""
    from repro_torch.core.screening import ScreenParams
    L, d = teng.W.shape
    n_blk = -(-L // 128)
    return ScreenParams(v=torch.zeros((1, d)),
                        cand_idx=torch.arange(n_blk, dtype=torch.int32)[None],
                        cand_len=torch.tensor([n_blk], dtype=torch.int32),
                        vocab_size=L, block=128)
