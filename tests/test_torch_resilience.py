"""The port's resilience layer against the JAX package's, on the CPU:

  * units, each driven by the same calls on the port's class and the
    reference's: ``LogicalClock``; ``FaultSpec`` validation;
    ``FaultInjector`` schedules from one seed (the same faults fire at the
    same opportunities, the same telemetry); ``guard_tokens`` and
    ``invalid_token_rows`` (also on a token tensor); the circuit breaker's
    lifecycle; the watchdog; ``timeout_s`` validation; ``SchedulerStalled``;
  * a transient step fault retried on a stream gives the fault-free run's
    tokens and cache leaves bit for bit, on ``nmt-deen-lstm`` (the LSTM
    state) and ``zamba2-2.7b`` (SSM states, conv tails and K/V); a faulted
    join leaves the stream as it was, generator included;
  * through the scheduler, against the reference's scheduler on the same
    requests, clock and fault seed: two transient faults retried
    (``retries == 2``), a permanent fault tripping the breaker and falling
    back to ``exact``, a ``timeout_s`` partial, a stalled drain raising
    ``SchedulerStalled``, and a chaos run of 18 requests over
    ``screened`` / ``screened-cuda`` / ``exact`` (the reference:
    ``screened-pallas``) whose outcomes and resilience counters equal the
    reference's.
"""
import numpy as np
import pytest
import torch

from repro.serving import CircuitBreaker as JBreaker
from repro.serving import ContinuousScheduler as JSched
from repro.serving import DecodeEngine as JEngine
from repro.serving import FaultInjector as JInjector
from repro.serving import FaultSpec as JFaultSpec
from repro.serving import HeadFault as JHeadFault
from repro.serving import LogicalClock as JClock
from repro.serving import SchedulerStalled as JStalled
from repro.serving import ServeRequest as JRequest
from repro.serving import StaticPolicy as JStatic
from repro.serving import StreamWatchdog as JWatchdog
from repro.serving import TierPolicy as JTier
from repro.serving.resilience.faults import guard_tokens as jguard
from repro.serving.resilience.faults import invalid_token_rows as jinvalid
from repro.serving.scheduler import TIER_DEADLINES
from repro_torch.serving import (CircuitBreaker, ContinuousScheduler,
                                 DecodeEngine, FaultInjector, FaultSpec,
                                 HeadFault, LogicalClock, SchedulerStalled,
                                 ServeRequest, StaticPolicy, StreamWatchdog,
                                 TierPolicy)
from repro_torch.serving.resilience.faults import (guard_tokens,
                                                   invalid_token_rows)
from repro_torch.tree import tree_leaves
from torch_serving_fixtures import (TWIN, UNTWIN, assert_decided, hybrid_fx,
                                    lstm_fx, outcome, prompts)

PORT = dict(clock=LogicalClock, spec=FaultSpec, injector=FaultInjector,
            fault=HeadFault, breaker=CircuitBreaker, watchdog=StreamWatchdog,
            guard=guard_tokens, invalid=invalid_token_rows,
            stalled=SchedulerStalled)
REF = dict(clock=JClock, spec=JFaultSpec, injector=JInjector,
           fault=JHeadFault, breaker=JBreaker, watchdog=JWatchdog,
           guard=jguard, invalid=jinvalid, stalled=JStalled)


@pytest.fixture(scope="module")
def lstm():
    return lstm_fx()


@pytest.fixture(scope="module")
def hybrid():
    return hybrid_fx()


# -- units, each against the reference's class --------------------------------

def _both(fn):
    got, want = fn(PORT), fn(REF)
    assert got == want
    return got


def test_logical_clock_and_fault_spec_validation():
    def drive(m):
        clk = m["clock"](10.0, dt_per_read=0.5)
        out = [clk(), clk(), clk.advance(2.0), m["clock"](3.0)()]
        for kw in (dict(site="decode", kind="transient"),
                   dict(site="step", kind="explode"),
                   dict(site="step", kind="transient", rate=1.5)):
            with pytest.raises(ValueError) as ei:
                m["spec"](**kw)
            out.append(str(ei.value))
        return out
    assert _both(drive)[:4] == [10.5, 11.0, 13.0, 3.0]


def test_injector_schedules_from_one_seed_equal_the_reference():
    def drive(m):
        inj = m["injector"](seed=123)
        inj.arm("step", "transient", rate=0.3)
        inj.arm("step", "permanent", head="svd", count=1, after=7)
        inj.arm("step", "stall", head="exact", rate=0.5)
        inj.arm("step", "nan", head="screened", rate=0.2)
        inj.arm("join", "sentinel", rate=0.4, count=3)
        inj.arm("tick", "delay", rate=0.25, delay_s=1e-3)
        trace = []
        for i in range(60):
            head = ("screened", "svd", "exact")[i % 3]
            for site in ("step", "join"):
                try:
                    inj.raise_for(site, head)
                    trace.append("ok")
                except m["fault"] as e:
                    trace.append((e.kind, e.transient, e.injected, e.site))
                toks = inj.corrupt(site, head, np.array([1, 2, 3]))
                trace.append((toks.dtype.kind, toks.tolist()
                              if toks.dtype.kind != "f" else "nan"))
            trace.append(inj.stalled(head))
            trace.append(inj.on_tick())
        return trace, inj.telemetry()
    trace, tel = _both(drive)
    assert tel["fired_total"] > 10


def test_guard_tokens_and_invalid_rows_equal_the_reference():
    def drive(m):
        out = [m["invalid"](np.array([0, 7, 8]), vocab=8),
               m["invalid"](np.array([1.0, np.nan]), vocab=8),
               m["invalid"](np.array([9, 3, 9]), vocab=8, rows=[1])]
        out.append(m["guard"](None, "step", "h", np.array([0, 5]),
                              vocab=8).tolist())
        inj = m["injector"]()
        inj.arm("step", "nan", head="h", count=1)
        inj.arm("step", "sentinel", head="h", count=1)
        for toks, i in ((np.array([0, -1]), None), (np.array([1, 2]), inj),
                        (np.array([1, 2]), inj)):
            with pytest.raises(m["fault"]) as ei:
                m["guard"](i, "step", "h", toks, vocab=8)
            e = ei.value
            out.append((e.kind, e.transient, e.injected, str(e)))
        out.append(m["guard"](inj, "step", "h", np.array([1, 2]),
                              vocab=8).tolist())
        return out
    _both(drive)
    # the port's guard takes the token tensor itself, copied to the host
    toks = torch.tensor([3, 9, 1], dtype=torch.int32)
    np.testing.assert_array_equal(
        guard_tokens(None, "step", "h", toks, vocab=8, rows=[0, 2]), [3, 9, 1])
    with pytest.raises(HeadFault, match=r"row\(s\) \[1\]"):
        guard_tokens(None, "step", "h", toks, vocab=8)


def test_breaker_lifecycle_and_watchdog_equal_the_reference():
    def drive(m):
        clk = m["clock"](0.0)
        seen = []
        br = m["breaker"](failure_threshold=3, cooldown_s=1.0, clock=clk,
                          latency_spike_s=0.1,
                          on_transition=lambda h, o, n: seen.append((h, o,
                                                                     n)))
        out = []
        for op in ("f", "f", "s", "f", "f", "f", "a", "+1.5", "a", "s",
                   "hard", "+2", "a", "f", "a", "l0.05", "l0.2"):
            if op == "f":
                br.record_failure("svd")
            elif op == "s":
                br.record_success("svd")
            elif op == "hard":
                br.record_failure("svd", kind="permanent", hard=True)
            elif op == "a":
                out.append(br.allow("svd"))
            elif op.startswith("+"):
                clk.advance(float(op[1:]))
            else:
                br.record_latency("exact", float(op[1:]))
            out.append(br.state("svd"))
        out += [seen, br.telemetry(), br.open_heads(), br.states()]
        wd = m["watchdog"](stall_timeout_s=1.0)
        wd.observe(1, 0, now=0.0)
        wd.observe(2, 0, now=0.0)
        wd.observe(1, 3, now=1.0)
        out += [wd.armed, wd.tracked, wd.stalled(now=1.5)]
        wd.forget(2)
        out += [wd.stalled(now=9.0), m["watchdog"]().armed]
        for bad in (lambda: m["breaker"](failure_threshold=0),
                    lambda: m["watchdog"](stall_timeout_s=0)):
            with pytest.raises(ValueError) as ei:
                bad()
            out.append(str(ei.value))
        return out
    _both(drive)


def test_timeout_validation_and_scheduler_stalled():
    p = np.array([1, 2, 3], np.int32)
    for req in (ServeRequest, JRequest):
        assert req(prompt=p, max_new=2).timeout_s is None
        assert req(prompt=p, max_new=2, timeout_s=0.5).timeout_s == 0.5
        for bad in (0, -1.0):
            with pytest.raises(ValueError, match="timeout_s"):
                req(prompt=p, max_new=2, timeout_s=bad)
    e = SchedulerStalled("stuck", rids=[3, 5], stats={"ticks": 7})
    assert isinstance(e, RuntimeError)
    assert e.rids == (3, 5) and e.stats == {"ticks": 7}


# -- a stream's rollback ---------------------------------------------------------

def _engine(fx, max_len=40):
    return DecodeEngine(fx["tmodel"], fx["tparams"], screen=fx["tscreen"],
                        max_len=max_len, device="cpu")


def _faulted_stream_run(fx, lens, injector, temperature=None):
    """Three requests joining at ticks 0, 1 and 3 of a width-3
    ``screened-cuda`` stream (the last one after a faulted join when the
    injector fires there); each refused step is stepped again. → (tokens
    by tag, the cache leaves after the last step that left a slot
    occupied, faults seen)."""
    eng = _engine(fx)
    ps = prompts(fx, 3, max(lens), seed=12)
    s = eng.open_stream("screened-cuda", width=3, temperature=temperature,
                        top_p=1.0, seed=5)
    s.fault_injector = injector
    reqs = [ServeRequest(prompt=ps[i, :n], max_new=6)
            for i, n in enumerate(lens)]
    done, faults, leaves, tick = [], 0, None, 0
    joins = {0: 0, 1: 1, 3: 2}
    while tick == 0 or s.n_active or joins:
        if tick in joins:
            while True:
                try:
                    s.join(reqs[joins[tick]], tag=joins[tick])
                    break
                except HeadFault:
                    faults += 1
            del joins[tick]
        try:
            done += s.step()
        except HeadFault:
            faults += 1
            continue
        if s.cache is not None:
            leaves = [leaf.clone() for leaf in tree_leaves(s.cache)]
        tick += 1
    return {tag: toks.tolist() for tag, _, toks in done}, leaves, faults


@pytest.mark.parametrize("family,temperature", [
    ("lstm", None), ("lstm", 0.9), ("hybrid", None)])
def test_stream_transient_retry_is_bit_identical(family, temperature, lstm,
                                                 hybrid):
    fx = lstm if family == "lstm" else hybrid
    lens = (8, 12, 9) if family == "lstm" else (20, 24, 17)
    clean, clean_leaves, n = _faulted_stream_run(fx, lens, None, temperature)
    assert n == 0 and len(clean) == 3
    inj = FaultInjector(seed=0)
    inj.arm("step", "transient", count=2, after=3)   # after every row joined
    inj.arm("join", "transient", count=1, after=2)   # the third join
    inj.arm("step", "nan", count=1, after=7)
    got, leaves, n = _faulted_stream_run(fx, lens, inj, temperature)
    assert n == 4
    assert got == clean
    assert len(leaves) == len(clean_leaves)
    for a, b in zip(leaves, clean_leaves):
        assert torch.equal(a, b)


def test_kv_cache_needs_no_restore(hybrid):
    """The K/V caches are not snapshotted: a refused hybrid step is undone
    by restoring the SSM leaves alone, and the retry writes the same K/V
    slot with the same values. After one step and its restore, the K/V
    leaves hold that step's writes and the SSM leaves the state before it;
    stepping again gives the fault-free step's cache bit for bit."""
    eng = _engine(hybrid)
    ps = prompts(hybrid, 2, 20, seed=14)
    outs = []
    for fault in (False, True):
        s = eng.open_stream("exact", width=2)
        s.join(ServeRequest(prompt=ps[0], max_new=4))
        s.join(ServeRequest(prompt=ps[1, :15], max_new=4))
        before = {k: [x.clone() for x in tree_leaves(s.cache[k])]
                  for k in ("ssm", "shared_attn")}
        if fault:
            s.fault_injector = FaultInjector()
            s.fault_injector.arm("step", "transient", count=1)
            with pytest.raises(HeadFault):
                s.step()
            for a, b in zip(tree_leaves(s.cache["ssm"]), before["ssm"]):
                assert torch.equal(a, b)
            changed = [not torch.equal(a, b) for a, b in zip(
                tree_leaves(s.cache["shared_attn"]), before["shared_attn"])]
            assert all(changed)             # the step's K/V writes stay
        s.step()
        outs.append([x.clone() for x in tree_leaves(s.cache)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# -- through the scheduler, against the reference's ------------------------------

def _sides(fx, max_len=36):
    t = DecodeEngine(fx["tmodel"], fx["tparams"], screen=fx["tscreen"],
                     max_len=max_len, device="cpu")
    j = JEngine(fx["jmodel"], fx["jparams"], screen=fx["jscreen"],
                max_len=max_len)
    return (dict(eng=t, sched=ContinuousScheduler, req=ServeRequest,
                 static=StaticPolicy, tier=TierPolicy, m=PORT,
                 name=lambda n: n),
            dict(eng=j, sched=JSched, req=JRequest, static=JStatic,
                 tier=JTier, m=REF, name=lambda n: TWIN.get(n, n)))


def _res(snap):
    """The resilience snapshot, heads under the port's names."""
    rz = dict(snap["resilience"] or {})
    if rz:
        rz["breaker_states"] = {UNTWIN.get(h, h): st for h, st in
                                rz["breaker_states"].items()}
        rz["breaker_transitions"] = [[t, UNTWIN.get(h, h), o, n]
                                     for t, h, o, n
                                     in rz["breaker_transitions"]]
    return rz


def test_scheduler_transient_retry_and_permanent_fallback(lstm):
    ps = prompts(lstm, 2, 8, seed=41)
    outs = []
    for side in _sides(lstm):
        m, nm = side["m"], side["name"]
        req = side["req"](prompt=ps[0], max_new=6)
        ref = side["sched"](side["eng"],
                            policy=side["static"](nm("screened-cuda")),
                            max_slots=2).serve([req])[0]
        inj = m["injector"](seed=0)
        inj.arm("step", "transient", head=nm("screened-cuda"), count=2)
        sched = side["sched"](
            side["eng"], policy=side["static"](nm("screened-cuda")),
            max_slots=2, fault_injector=inj, max_retries=3,
            breaker=m["breaker"](failure_threshold=5, clock=m["clock"]()))
        retried = sched.serve([req])[0]
        rz = sched.stats.snapshot()["resilience"]
        inj = m["injector"](seed=0)
        inj.arm("step", "permanent", head=nm("screened-cuda"), count=1)
        br = m["breaker"](failure_threshold=3, cooldown_s=100.0,
                          clock=m["clock"]())
        sched = side["sched"](side["eng"],
                              policy=side["static"](nm("screened-cuda")),
                              max_slots=2, fault_injector=inj, breaker=br)
        fell = sched.serve([side["req"](prompt=ps[1], max_new=6)])[0]
        outs.append(([outcome(r, TWIN) for r in (ref, retried, fell)],
                     (rz["faults_transient"], rz["retries"],
                      rz["fallbacks"]),
                     br.state(nm("screened-cuda")),
                     _res(sched.stats.snapshot())))
    assert outs[0] == outs[1]
    (ref, retried, fell), counts, state, rz = outs[0]
    assert retried == ref and counts == (2, 2, 0)
    assert fell[1] == "exact" and state == "open"
    assert rz["faults_permanent"] == 1 and rz["breaker_trips"] == 1
    assert_decided(lstm, ps[0], np.asarray(ref[2]), screened=True)
    solo = _engine(lstm).generate(ps[1][None], 6).tokens[0]
    assert fell[2] == solo.tolist()


def test_scheduler_timeout_partial_and_stalled_drain(lstm):
    ps = prompts(lstm, 3, 6, seed=53)
    outs = []
    for side in _sides(lstm):
        m = side["m"]
        clk = m["clock"](0.0, dt_per_read=1e-3)
        slow = side["req"](prompt=ps[0], max_new=24, timeout_s=0.02)
        fine = side["req"](prompt=ps[1], max_new=4)
        sched = side["sched"](side["eng"], max_slots=2, clock=clk)
        res = sched.serve([slow, fine])
        inj = m["injector"](seed=0)
        inj.arm("step", "stall")                    # any head, forever
        stuck = side["sched"](side["eng"], policy=side["static"]("exact"),
                              max_slots=2, fault_injector=inj)
        stuck.submit(side["req"](prompt=ps[2], max_new=4))
        with pytest.raises(m["stalled"]) as ei:
            stuck.drain()
        outs.append(([outcome(r) for r in res],
                     sched.stats.snapshot()["resilience"]["timed_out"],
                     ei.value.rids, ei.value.stats["ticks"]))
    assert outs[0] == outs[1]
    res, timed_out, rids, ticks = outs[0]
    assert res[0][0] == "AdmissionRejected" and res[0][3] == "timeout"
    assert 0 < len(res[0][2]) < 24 and res[1][0] == "ServeResult"
    assert timed_out == 1 and rids == (0,) and ticks > 0


def test_chaos_outcomes_equal_the_reference(lstm):
    """18 requests over screened / screened-cuda / exact under transient,
    permanent, NaN, stall and tick-delay faults, with breaker, watchdog,
    retries and timeouts armed: every request ends typed, and the outcomes
    (types, heads, tokens, stages) and the resilience counters equal the
    reference's on screened / screened-pallas / exact."""
    n_req = 18
    ps = prompts(lstm, n_req, 8, seed=71)
    tiers = ["realtime", "standard", "batch"]
    outs = []
    for side in _sides(lstm):
        m, nm = side["m"], side["name"]
        clock = m["clock"](0.0, dt_per_read=1e-3)
        inj = m["injector"](seed=7, clock=clock)
        inj.arm("step", "transient", head=nm("screened-cuda"), count=2,
                after=2)
        inj.arm("step", "nan", head="screened", count=1, after=2)
        inj.arm("step", "permanent", head="screened", count=1, after=6)
        inj.arm("step", "stall", head="exact", count=6, after=3)
        inj.arm("join", "transient", head="screened", count=1, after=2)
        inj.arm("tick", "delay", delay_s=2e-3, rate=0.1, count=5)
        sched = side["sched"](
            side["eng"],
            policy=side["tier"]({"realtime": nm("screened-cuda"),
                                 "standard": "screened"},
                                default="exact"),
            max_slots=3, max_streams=8,
            deadlines={t: s * 10 for t, s in TIER_DEADLINES.items()},
            clock=clock, fault_injector=inj,
            breaker=m["breaker"](failure_threshold=3, cooldown_s=0.05,
                                 clock=clock),
            watchdog=m["watchdog"](stall_timeout_s=1e-2), max_retries=2)
        for i, p in enumerate(ps):
            sched.submit(side["req"](prompt=p, max_new=4,
                                     latency_tier=tiers[i % 3],
                                     timeout_s=0.004 if i in (5, 11)
                                     else None))
        results = sched.drain(max_ticks=2000)
        outs.append(([outcome(r, TWIN) for r in results],
                     _res(sched.stats.snapshot()),
                     sorted(sched.fault_rids), inj.telemetry()["fired_total"],
                     sched.stats.snapshot()["completed"]))
    assert outs[0] == outs[1]
    results, rz, touched, fired, completed = outs[0]
    assert len(results) == n_req and completed >= n_req // 3
    assert {r[0] for r in results} <= {"ServeResult", "AdmissionRejected"}
    assert rz["faults_transient"] >= 1 and rz["faults_permanent"] >= 1
    assert rz["fault_kinds"].get("corrupt", 0) >= 1
    assert rz["retries"] >= 1 and rz["fallbacks"] >= 1
    assert rz["breaker_trips"] >= 1 and fired >= 8
    for i, r in enumerate(results):
        if r[0] == "ServeResult":
            assert_decided(lstm, ps[i], np.asarray(r[2]),
                           screened=r[1] != "exact")
