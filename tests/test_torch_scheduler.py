"""The port's continuous batching — ``DecodeStream`` and
``ContinuousScheduler`` — against the JAX package's, on the CPU, on the same
weights, requests, policies and fake clock (``torch_serving_fixtures``):

  * a stream's joins mid-decode (different ticks, prompt lengths, a
    ``max_new == 1`` join) give solo ``generate``'s tokens and the JAX
    ``DecodeStream``'s on the same joins, on ``nmt-deen-lstm`` and on
    ``zamba2-2.7b`` (per-row positions through the hybrid's K/V caches);
    the stream's slab is its own (a ``generate`` between its ticks leaves
    it alone) and goes back to the engine when the stream empties;
  * capacity and guards: a full stream refuses a join, and a join past
    ``max_len`` raises on every family, as the reference's does;
  * a width-1 sampled stream reproduces solo sampled ``generate``;
  * ``drain`` equals ``serve_batch`` and the JAX scheduler's ``drain``:
    result types, tokens, heads and the ``AdmissionRejected`` stages, under
    ``AcceptAll`` and under a ``BudgetAdmission`` that rejects and
    downgrades; a second drain gives the same results;
  * preemption: the lowest tier yields first, one eviction per waiter's
    signature per tick, outcomes equal to the reference's;
  * ``pop_results`` and result ids that stay monotonic across it;
  * the launcher's exit codes on bad flags equal the reference's.

Greedy tokens are held equal where the reference's steps are decided by a
top-2 gap above 1e-4 (asserted).
"""
import numpy as np
import pytest

from repro.launch import serve as jserve
from repro.serving import BudgetAdmission as JBudget
from repro.serving import ContinuousScheduler as JSched
from repro.serving import DecodeEngine as JEngine
from repro.serving import ServeRequest as JRequest
from repro.serving import StaticPolicy as JStatic
from repro.serving import TierPolicy as JTier
from repro_torch.launch import serve as tserve
from repro_torch.serving import (BudgetAdmission, ContinuousScheduler,
                                 DecodeEngine, LogicalClock, ServeRequest,
                                 ServeResult, StaticPolicy, TierPolicy)
from torch_serving_fixtures import (TWIN, assert_decided, hybrid_fx, lstm_fx,
                                    outcome, prompts)

TIERS = ("realtime", "standard", "batch")


@pytest.fixture(scope="module")
def lstm():
    return lstm_fx()


@pytest.fixture(scope="module")
def hybrid():
    return hybrid_fx()


def _engines(fx, max_len=40):
    teng = DecodeEngine(fx["tmodel"], fx["tparams"], screen=fx["tscreen"],
                        max_len=max_len, device="cpu")
    jeng = JEngine(fx["jmodel"], fx["jparams"], screen=fx["jscreen"],
                   max_len=max_len)
    return teng, jeng


def _drive(stream, reqs, make, between=None):
    """Join a at tick 0, b after two steps, c (max_new 1) after three, then
    step until empty. ``between`` runs after the second step."""
    a, b, c = (make(r) for r in reqs)
    stream.join(a, tag="a")
    done = stream.step() + stream.step()
    if between is not None:
        between()
    stream.join(b, tag="b")
    done += stream.step()
    stream.join(c, tag="c")
    while stream.n_active:
        done += stream.step()
    done += stream.pop_finished()
    return {tag: np.asarray(toks) for tag, _, toks in done}


@pytest.mark.parametrize("family", ["lstm", "hybrid"])
def test_stream_join_mid_decode_matches_solo_and_reference(family, lstm,
                                                           hybrid):
    fx = lstm if family == "lstm" else hybrid
    lens = (8, 12, 8) if family == "lstm" else (20, 24, 17)
    ps = prompts(fx, 3, max(lens), seed=4)
    kws = [dict(prompt=ps[i, :n], max_new=m)
           for i, (n, m) in enumerate(zip(lens, (8, 5, 1)))]
    teng, jeng = _engines(fx, max_len=40)
    head = "screened-cuda"
    # a generate at another width between the stream's ticks must not
    # disturb the stream's own slab
    side = lambda: teng.generate(ps[:2, :6], 3, head=head)
    got = _drive(teng.open_stream(head, width=3), kws,
                 lambda kw: ServeRequest(**kw), between=side)
    want = _drive(jeng.open_stream(TWIN[head], width=3), kws,
                  lambda kw: JRequest(**kw))
    assert set(got) == set(want) == {"a", "b", "c"}
    for tag, kw in zip("abc", kws):
        assert_decided(fx, kw["prompt"], want[tag], screened=True)
        np.testing.assert_array_equal(got[tag], want[tag])
        solo = teng.generate(kw["prompt"][None], kw["max_new"], head=head)
        np.testing.assert_array_equal(got[tag], solo.tokens[0])


def test_stream_slab_is_lent_and_given_back(lstm):
    teng, _ = _engines(lstm)
    p = prompts(lstm, 2, 6, seed=5)
    s = teng.open_stream("exact", width=2)
    assert s.cache is None and s.idle
    s.join(ServeRequest(prompt=p[0], max_new=3))
    slab = s._slab
    assert slab.pos.shape == (2,) and slab.key == (2, 1)
    assert s.cache is slab.cache and slab.saved is not None
    while s.n_active:
        s.step()
    assert s._slab is None and s.cache is None       # given back when empty
    key = (2, (s.head.step_key(), "greedy"))
    assert slab.owner == key[1]
    assert [r() for r in teng._free_stream_slabs[key]] == [slab]
    s2 = teng.open_stream("exact", width=2)          # the next stream of
    s2.join(ServeRequest(prompt=p[1], max_new=3))    # the step takes it
    assert s2._slab is slab
    other = teng.open_stream("screened-cuda", width=2)   # another step's
    other.join(ServeRequest(prompt=p[1], max_new=3))     # stream does not
    assert other._slab is not slab and other._slab.key == (2, 2)
    # evicting the last occupant gives it back too
    s2.evict(0)
    assert s2._slab is None and [r() for r in
                                 teng._free_stream_slabs[key]] == [slab]


@pytest.mark.parametrize("family", ["lstm", "hybrid", "ssm"])
def test_stream_capacity_and_guards(family, lstm, hybrid):
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models.model import Model as JModel
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import Model
    if family == "ssm":
        jm = JModel(j_get_config("mamba2-1.3b").reduced())
        jp = jm.init(jax.random.key(0))
        tm = Model(get_config("mamba2-1.3b").reduced())
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
        vocab = jm.cfg.vocab_size
    else:
        fx = lstm if family == "lstm" else hybrid
        jm, jp, tm, tp = (fx["jmodel"], fx["jparams"], fx["tmodel"],
                          fx["tparams"])
        vocab = fx["vocab"]
    teng = DecodeEngine(tm, tp, max_len=16, device="cpu")
    jeng = JEngine(jm, jp, max_len=16)
    p = np.random.default_rng(1).integers(0, vocab, 6).astype(np.int32)
    s = teng.open_stream("exact", width=2)
    s.join(ServeRequest(prompt=p, max_new=3))
    s.join(ServeRequest(prompt=p, max_new=3))
    assert s.free_slots == 0 and not s.idle
    with pytest.raises(RuntimeError):
        s.join(ServeRequest(prompt=p, max_new=3))
    for eng, req in ((teng, ServeRequest), (jeng, JRequest)):
        with pytest.raises(ValueError, match="max_len is 16"):   # 6 + 20
            eng.open_stream("exact", width=1).join(req(prompt=p, max_new=20))
        with pytest.raises(ValueError):
            eng.open_stream("exact", width=0)


def test_stream_width1_sampled_reproduces_solo_generate(lstm):
    teng, _ = _engines(lstm)
    p = prompts(lstm, 1, 7, seed=4)[0]
    for head in ("screened-cuda", "exact"):
        req = ServeRequest(prompt=p, max_new=6, temperature=0.9, top_p=0.95,
                           seed=11)
        s = teng.open_stream(head, width=1, temperature=0.9, top_p=0.95,
                             seed=11)
        s.join(req, tag=0)
        done = []
        while s.n_active:
            done += s.step()
        solo = teng.generate(p[None], 6, head=head, temperature=0.9,
                             top_p=0.95, seed=11).tokens[0]
        np.testing.assert_array_equal(done[0][2], solo)


def _traffic(fx, n, sampled_idx=(), seed=21, lens=(6, 9)):
    ps = prompts(fx, n, max(lens), seed=seed)
    kws = []
    for i in range(n):
        sampled = i in sampled_idx
        kws.append(dict(prompt=ps[i, :lens[i % len(lens)]],
                        max_new=4 + (i % 3), latency_tier=TIERS[i % 3],
                        temperature=0.9 if sampled else None,
                        top_p=0.95 if sampled else 1.0, seed=7))
    return kws


def test_drain_equals_serve_batch_and_the_reference(lstm):
    teng, jeng = _engines(lstm)
    tpol = TierPolicy({"realtime": "screened-cuda", "standard": "screened"},
                      default="exact")
    jpol = JTier({"realtime": "screened-pallas", "standard": "screened"},
                 default="exact")
    kws = _traffic(lstm, 7)
    treqs = [ServeRequest(**kw) for kw in kws]
    jreqs = [JRequest(**kw) for kw in kws]
    got = ContinuousScheduler(teng, policy=tpol, max_slots=3).serve(treqs)
    batch = teng.serve_batch(treqs, policy=tpol)
    want = JSched(jeng, policy=jpol, max_slots=3,
                  clock=LogicalClock(dt_per_read=1e-3)).serve(jreqs)
    assert {r.head for r in got} == {"screened-cuda", "screened", "exact"}
    for i, (r, b, w, kw) in enumerate(zip(got, batch, want, kws)):
        assert isinstance(r, ServeResult) and r.request is treqs[i]
        assert outcome(r, TWIN) == outcome(w) == outcome(b, TWIN)
        assert_decided(lstm, kw["prompt"], w.tokens,
                       screened=w.head != "exact")
    counts = teng.compiled_step_counts()
    again = ContinuousScheduler(teng, policy=tpol, max_slots=3).serve(treqs)
    assert teng.compiled_step_counts() == counts
    assert [outcome(r) for r in again] == [outcome(r) for r in got]


def test_budget_reject_and_downgrade_match_the_reference(lstm):
    teng, jeng = _engines(lstm)
    cat = teng.head_catalog(["exact", "screened-cuda"])
    jcat = jeng.head_catalog(["exact", "screened-pallas"])
    assert cat["exact"]["flops_per_query"] == jcat["exact"]["flops_per_query"]
    # two exact requests and one downgraded to screened-cuda fit at once
    budget = 2.8 * cat["exact"]["flops_per_query"]
    kws = _traffic(lstm, 9, seed=8)
    for i in (2, 5):
        kws[i]["accuracy_floor"] = 1.0          # exact only: rejected
    outs = {}
    for side, (eng, pol, adm, req) in {
            "port": (teng, TierPolicy({"never": "screened-cuda"},
                                      default="exact"),
                     BudgetAdmission(flops_budget=budget), ServeRequest),
            "ref": (jeng, JTier({"never": "screened-pallas"},
                                default="exact"),
                    JBudget(flops_budget=budget), JRequest)}.items():
        sched = (ContinuousScheduler if side == "port" else JSched)(
            eng, policy=pol, admission=adm, max_slots=4,
            clock=LogicalClock(dt_per_read=1e-4))
        out = sched.serve([req(**kw) for kw in kws])
        outs[side] = ([outcome(r, TWIN) for r in out],
                      {k: sched.stats.snapshot()[k]
                       for k in ("admitted", "rejected", "downgraded",
                                 "completed")},
                      [getattr(r, "reason", "") for r in out])
    assert outs["port"][:2] == outs["ref"][:2]
    stages = [o[3] for o in outs["port"][0]]
    assert stages.count("admission") >= 2
    assert outs["port"][1]["downgraded"] >= 1
    for reason, ref_reason in zip(outs["port"][2], outs["ref"][2]):
        assert reason.split(":")[0] == ref_reason.split(":")[0]


def test_preemption_lowest_tier_first_one_per_signature(lstm):
    """Two lanes of batch and standard work fill the streams; a realtime
    waiter on the exact lane preempts the batch occupant of its own lane
    (the lowest tier) and only one per tick; a second waiter of the same
    signature in the same tick does not evict again."""
    teng, jeng = _engines(lstm, max_len=40)
    ps = prompts(lstm, 5, 6, seed=2)
    plan = [(0, "batch", 20), (1, "standard", 20)]
    outs = {}
    for side, eng, req, sched_cls, pol in (
            ("port", teng, ServeRequest, ContinuousScheduler,
             StaticPolicy("exact")),
            ("ref", jeng, JRequest, JSched, JStatic("exact"))):
        clk = LogicalClock()
        sched = sched_cls(eng, policy=pol, max_slots=2, max_streams=1,
                          deadlines={"batch": 0.5, "standard": 0.5,
                                     "realtime": 10.0}, clock=clk)
        for i, tier, n in plan:
            sched.submit(req(prompt=ps[i], max_new=n, latency_tier=tier))
        sched.step()
        clk.t = 1.0                         # both lapse their deadlines
        for i in (2, 3):
            sched.submit(req(prompt=ps[i], max_new=3,
                             latency_tier="realtime"))
        sched.step()
        first_tick = sched.stats.preempted
        out = sched.drain()
        outs[side] = ([outcome(r) for r in out], first_tick,
                      sched.stats.preempted)
    assert outs["port"] == outs["ref"]
    res, first_tick, total = outs["port"]
    assert first_tick == 1                  # one eviction per tick
    assert res[0][0] == "AdmissionRejected" and res[0][3] == "preempt"
    assert total == 2 and res[1][3] == "preempt"   # batch went first
    solo = teng.generate(ps[0][None], 20).tokens[0]
    np.testing.assert_array_equal(res[0][2], solo[:len(res[0][2])])


def test_pop_results_and_monotonic_ids(lstm):
    teng, _ = _engines(lstm)
    sched = ContinuousScheduler(teng, max_slots=2)
    ps = prompts(lstm, 4, 6, seed=6)
    ids = [sched.submit(ServeRequest(prompt=p, max_new=3)) for p in ps[:2]]
    sched.drain()
    first = sched.pop_results()
    assert [r.request.prompt.tolist() for r in first] == \
        [p.tolist() for p in ps[:2]]
    assert sched.pop_results() == [] and sched.results() == []
    ids += [sched.submit(ServeRequest(prompt=p, max_new=2 + i))
            for i, p in enumerate(ps[2:])]
    assert ids == [0, 1, 2, 3]              # ids keep counting after a pop
    sched.step()
    part = sched.pop_results()              # in-flight work stays behind
    rest = sched.drain()
    assert [len(r.tokens) for r in part + rest] == [2, 3]
    assert isinstance(rest[-1], ServeResult)


def test_scheduler_refuses_pool_and_spec(lstm, hybrid):
    """The page pool serves the LSTM family only (the attention page store
    is Queue 1 item 9.1), so a hybrid engine's paged stream, and the
    scheduler lane that opens one, refuse; a spec stream refuses a draft
    that is its verify head. The LSTM takes both (tests/test_torch_spec.py,
    tests/test_torch_kvpool.py)."""
    from repro_torch.serving import PagePool, SpecPolicy
    teng, _ = _engines(hybrid)
    with pytest.raises(NotImplementedError, match="lstm"):
        teng.open_paged_stream(PagePool(8, 4))
    sched = ContinuousScheduler(teng, kv_pool=PagePool(8, 4))
    sched.submit(ServeRequest(prompt=prompts(hybrid, 1, 6, seed=1)[0],
                              max_new=2))
    with pytest.raises(NotImplementedError, match="lstm"):
        sched.step()
    lteng, _ = _engines(lstm)
    with pytest.raises(ValueError, match="DISTINCT"):
        lteng.open_spec_stream("exact")
    ContinuousScheduler(lteng, kv_pool=PagePool(8, 4), spec=SpecPolicy())


@pytest.mark.parametrize("argv", [
    ["--head", "screened", "--train-steps", "1"],
    ["--head", "nope"],
    ["--log-jsonl", "ticks.jsonl"],
    ["--scheduler", "--draft-head", "nope"],
    ["--draft-head", "screened", "--l2s"],
    ["--scheduler", "--draft-head", "exact"],
    ["--scheduler", "--draft-head", "screened"],
], ids=["no-screen", "unknown-head", "jsonl-without-scheduler",
        "draft-unknown", "draft-without-scheduler", "draft-exact",
        "draft-without-screen"])
def test_launcher_bad_flags_exit_like_the_reference(argv, capsys):
    base = ["--arch", "ptb-small-lstm", "--reduced"]
    want = jserve.main(base + argv)
    got = tserve.main(base + argv + ["--device", "cpu"])
    assert got == want == 2
    assert "trained" not in capsys.readouterr().out   # refused before training
