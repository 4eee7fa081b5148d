"""The port's speculative decoding (``repro_torch.serving.spec``) against the
JAX package's, on the CPU, on the same weights (``torch_serving_fixtures``):

  * the acceptance math draws the reference's bits from the same arrays and
    the same ``np.random.Generator``; the emission identity holds;
  * ``SpecPolicy`` and ``DraftLenController`` pick what the reference's
    pick on the same catalogs and rates; ``ServeRequest``'s spec fields;
  * ``dist_logits`` of ``exact``, ``screened`` and ``screened-cuda`` (its
    plain path) equal the reference's (``screened-pallas`` in interpret
    mode) within 1e-5 with identical support, including the padded rows
    of a last vocab tile and sentinel slots; ``sample`` draws inside it;
  * greedy ``SpecDecodeStream`` tokens equal the reference's
    ``SpecDecodeStream``'s and the port's plain exact ``generate`` bit for
    bit, on ``nmt-deen-lstm`` and on ``zamba2-2.7b`` (snapshot restore of
    the SSM states from the ring, K/V left unrestored), with the same
    round counters; the engine's ``spec-verify`` step is cached and
    counted; a refused round is undone whole;
  * sampled spec streams, the guards, the join headroom, the kv_pool
    reservation;
  * ``ContinuousScheduler(spec=...)``: results, composite head names and
    the ``spec`` stats equal the reference's; the draft is dropped before
    the head; spec lanes; a tripped draft degrades to plain decode;
  * the launcher's ``--draft-head`` exit codes equal the reference's.

Greedy tokens are held equal where the reference's steps are decided by a
top-2 gap above 1e-4 (asserted).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.spec.acceptance as jacc
from repro import heads as jheads
from repro.core.screening import ScreenParams as JScreen
from repro.core.screening import candidates_to_padded
from repro.launch import serve as jserve
from repro.serving import ContinuousScheduler as JSched
from repro.serving import DecodeEngine as JEngine
from repro.serving import ServeRequest as JRequest
from repro.serving import SpecPolicy as JSpecPolicy
from repro.serving import StaticPolicy as JStatic
from repro.serving.spec import DraftLenController as JController
from repro_torch import heads
from repro_torch.heads.base import NEG_INF
from repro_torch.interop import screen_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.serving import (BudgetAdmission, CircuitBreaker,
                                 ContinuousScheduler, DecodeEngine,
                                 FaultInjector, HeadFault, LogicalClock,
                                 PagePool, PoolExhausted, ServeRequest,
                                 ServeResult, SpecPolicy, StaticPolicy)
from repro_torch.serving.scheduler.queue import head_flops
from repro_torch.serving.spec import (DraftLenController, accept_draft,
                                      accept_step, emission_distribution,
                                      greedy_accept_lengths, row_probs,
                                      spec_step_flops)
from torch_serving_fixtures import (assert_decided, dense_fx, hybrid_fx,
                                    lstm_fx, outcome, prompts)


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


def _run_stream(stream, requests):
    done = {}
    for i, r in enumerate(requests):
        stream.join(r, tag=i)
    for _ in range(200):
        for tag, _, toks in stream.step():
            done[tag] = toks
        if stream.idle:
            return done
    raise AssertionError("stream never drained")


# -- acceptance math ----------------------------------------------------------

def test_row_probs_empty_convention():
    full = row_probs(np.array([0.0, math.log(3.0)]))
    np.testing.assert_allclose(full, [0.25, 0.75])
    np.testing.assert_array_equal(row_probs(np.full(4, NEG_INF)),
                                  np.zeros(4))
    one = np.full(4, NEG_INF)
    one[2] = 1.5
    np.testing.assert_allclose(row_probs(one), [0, 0, 1, 0])
    rng = np.random.default_rng(1)
    for row in (rng.standard_normal(9), np.full(3, NEG_INF), one):
        np.testing.assert_array_equal(row_probs(row), jacc.row_probs(row))


def test_greedy_accept_lengths():
    draft = np.array([[1, 2, 3], [1, 9, 3], [9, 2, 3]])
    exact = np.array([[1, 2, 3], [1, 2, 3], [1, 2, 3]])
    got = greedy_accept_lengths(draft, exact)
    np.testing.assert_array_equal(got, [3, 1, 0])
    np.testing.assert_array_equal(got, jacc.greedy_accept_lengths(draft,
                                                                  exact))


def _qp(rng, V, frac, empty_draft):
    q = rng.standard_normal(V) * 3.0
    p = rng.standard_normal(V) * 3.0
    q[rng.random(V) < frac] = NEG_INF
    if empty_draft:
        q[:] = NEG_INF
    p[rng.random(V) < frac * 0.5] = NEG_INF
    if np.all(p <= NEG_INF / 2):
        p[rng.integers(V)] = 0.0
    return q, p


def test_emission_identity_property():
    """The rejection rule's analytic emitted law equals the TARGET law for
    random (q, p) pairs, masked entries and empty draft rows included, and
    equals the reference's bit for bit."""
    from hypothesis import given, settings, strategies as hst

    @settings(max_examples=100, deadline=None)
    @given(hst.integers(0, 2**32 - 1), hst.integers(2, 12),
           hst.floats(0.0, 1.0), hst.booleans())
    def check(seed, V, frac, empty_draft):
        q, p = _qp(np.random.default_rng(seed), V, frac, empty_draft)
        emitted = emission_distribution(q, p)
        np.testing.assert_allclose(emitted, row_probs(p), atol=1e-12)
        np.testing.assert_array_equal(emitted,
                                      jacc.emission_distribution(q, p))

    check()


def test_emission_identity_numpy_sweep():
    rng = np.random.default_rng(0)
    for trial in range(300):
        V = int(rng.integers(2, 16))
        q, p = _qp(rng, V, trial / 300.0, trial % 7 == 0)
        np.testing.assert_allclose(emission_distribution(q, p),
                                   row_probs(p), atol=1e-12)


def test_accept_step_draws_the_reference_bits():
    """The same rows and the same Generator seed give the reference's
    (accepted, token) sequence, rejections and residual draws included."""
    rows = np.random.default_rng(3)
    cases = [(*_qp(rows, 6, 0.3, i % 5 == 0), int(rows.integers(6)))
             for i in range(40)]
    got, want = np.random.default_rng(11), np.random.default_rng(11)
    for q, p, d in cases:
        assert accept_step(got, d, q, p) == jacc.accept_step(want, d, q, p)
    assert got.random() == want.random()          # the same draws consumed


def test_accept_draft_draws_the_reference_bits():
    rows = np.random.default_rng(4)
    for trial in range(20):
        n, V = 4, 7
        q = rows.standard_normal((n, V))
        p = rows.standard_normal((n, V)) * 2
        d = rows.integers(0, V, n)
        a, b = np.random.default_rng(trial), np.random.default_rng(trial)
        assert accept_draft(a, d, q, p) == jacc.accept_draft(b, d, q, p)


def test_accept_step_monte_carlo():
    rng = np.random.default_rng(7)
    q = np.array([2.0, NEG_INF, 0.0, 1.0])
    p = np.array([0.0, 1.0, 1.0, NEG_INF])
    counts = np.zeros(4)
    n = 20_000
    for _ in range(n):
        d = rng.choice(4, p=row_probs(q))
        _, tok = accept_step(rng, int(d), q, p)
        counts[tok] += 1
    np.testing.assert_allclose(counts / n, row_probs(p), atol=0.02)


def test_accept_step_empty_draft_row():
    ok, tok = accept_step(np.random.default_rng(0), 0, np.full(3, NEG_INF),
                          np.array([NEG_INF, 0.0, NEG_INF]))
    assert not ok and tok == 1


def test_accept_step_empty_target_raises():
    with pytest.raises(ValueError, match="EMPTY target"):
        accept_step(np.random.default_rng(0), 0, np.full(3, NEG_INF),
                    np.full(3, NEG_INF))


def test_accept_draft_stops_at_first_rejection():
    rng = np.random.default_rng(1)
    n, V = 4, 5
    q = np.zeros((n, V))
    p = np.full((n, V), NEG_INF)
    p[:, 2] = 0.0
    emitted, a = accept_draft(rng, np.array([2, 2, 0, 0]), q, p)
    assert a == 2 and emitted == [2, 2, 2]
    emitted, a = accept_draft(rng, np.array([2, 2, 2, 2]), q, p)
    assert a == 4 and emitted == [2, 2, 2, 2]


# -- policy + controller ------------------------------------------------------

def _cat(**hs):
    return {n: {"flops_per_query": f, "bytes_per_query": float(f),
                "supports_sampling": True, "supports_dist": True,
                "n_shards": None, **extra}
            for n, (f, extra) in hs.items()}


def test_draft_len_controller():
    c = DraftLenController(4, low=0.45, high=0.75, ema=1.0)
    assert [c.observe(x) for x in (0.1, 0.0, 0.0, 0.0)] == [3, 2, 1, 1]
    for _ in range(5):
        c.observe(1.0)
    assert c.n == 4
    with pytest.raises(ValueError):
        DraftLenController(0)
    rates = np.random.default_rng(2).random(40)
    t, j = DraftLenController(6), JController(6)
    assert [t.observe(r) for r in rates] == [j.observe(r) for r in rates]
    assert t.acceptance == j.acceptance


def test_spec_policy_default_drafts_lead_with_the_kernel_head():
    assert SpecPolicy().drafts == ("screened-cuda", "screened", "adaptive")
    assert JSpecPolicy().drafts[1:] == SpecPolicy().drafts[1:]


# (policy kwargs, catalog, request kwargs, verify head, max_len)
_POLICY_CASES = {
    "bytes-tie": ({"drafts": ("screened-pallas", "screened", "adaptive")},
                  _cat(**{"exact": (100.0, {}), "screened": (10.0, {}),
                          "screened-pallas": (10.0, {"bytes_per_query": 1.0}),
                          "adaptive": (40.0, {})}), {}, "exact", None),
    "min-ratio": ({"drafts": ("adaptive",), "min_ratio": 4.0},
                  _cat(**{"exact": (100.0, {}), "adaptive": (40.0, {})}),
                  {}, "exact", None),
    "nan-cost": ({"drafts": ("screened",)},
                 _cat(**{"exact": (100.0, {}), "screened": (
                     math.nan, {"bytes_per_query": 1.0})}), {}, "exact",
                 None),
    "non-exact-verify": ({}, _cat(**{"exact": (100.0, {}),
                                     "screened": (10.0, {})}), {},
                         "screened", None),
    "unknown-verify": ({}, _cat(**{"exact": (100.0, {})}), {}, "nope", None),
    "sampled-nodist": ({"drafts": ("nodist", "screened")},
                       _cat(**{"exact": (100.0, {}), "screened": (10.0, {}),
                               "nodist": (5.0, {"supports_dist": False})}),
                       {"temperature": 0.8, "seed": 1}, "exact", None),
    "greedy-nodist": ({"drafts": ("nodist", "screened")},
                      _cat(**{"exact": (100.0, {}), "screened": (10.0, {}),
                              "nodist": (5.0, {"supports_dist": False})}),
                      {}, "exact", None),
    "sampled-sharded": ({"drafts": ("screened",)},
                        _cat(**{"exact-sharded": (50.0, {"n_shards": 4}),
                                "screened": (10.0, {})}),
                        {"temperature": 0.8, "seed": 1}, "exact-sharded",
                        None),
    "explicit": ({"drafts": ("screened",)},
                 _cat(**{"exact": (100.0, {}), "screened": (10.0, {}),
                         "adaptive": (90.0, {})}),
                 {"draft_head": "adaptive"}, "exact", None),
    "explicit-unknown": ({"drafts": ("screened",)},
                         _cat(**{"exact": (100.0, {}),
                                 "screened": (10.0, {})}),
                         {"draft_head": "nope"}, "exact", None),
    "no-headroom": ({"drafts": ("screened",)},
                    _cat(**{"exact": (100.0, {}), "screened": (10.0, {})}),
                    {"max_new": 10, "plen": 10}, "exact", 20),
    "headroom": ({"drafts": ("screened",)},
                 _cat(**{"exact": (100.0, {}), "screened": (10.0, {})}),
                 {"max_new": 10, "plen": 10}, "exact", 25),
    "breaker-open": ({"drafts": ("screened", "adaptive")},
                     _cat(**{"exact": (100.0, {}),
                             "screened": (10.0, {"breaker_open": True}),
                             "adaptive": (40.0, {})}), {}, "exact", None),
}


def _policy_pick_equals_the_reference(case):
    pkw, cat, rkw, verify, max_len = _POLICY_CASES[case]
    rkw = dict(rkw)
    plen = rkw.pop("plen", 4)
    rkw.setdefault("max_new", 8)
    got = SpecPolicy(**pkw).draft_for(
        ServeRequest(prompt=np.zeros(plen, np.int32), **rkw), verify, cat,
        max_len=max_len)
    want = JSpecPolicy(**pkw).draft_for(
        JRequest(prompt=np.zeros(plen, np.int32), **rkw), verify, cat,
        max_len=max_len)
    assert got == want
    return got


@pytest.mark.parametrize("case", ["bytes-tie", "min-ratio", "nan-cost",
                                  "non-exact-verify", "unknown-verify",
                                  "breaker-open"])
def test_spec_policy_picks_cheapest_modeled_draft(case):
    """The reference's pick on the same catalog: flops first, bytes break a
    tie, min_ratio, NaN costs, non-exact or unknown verify heads, and a
    draft whose breaker is open."""
    got = _policy_pick_equals_the_reference(case)
    assert got == {"bytes-tie": "screened-pallas",
                   "breaker-open": "adaptive"}.get(case)


@pytest.mark.parametrize("case", ["sampled-nodist", "greedy-nodist",
                                  "sampled-sharded"])
def test_spec_policy_sampled_constraints(case):
    got = _policy_pick_equals_the_reference(case)
    assert got == {"sampled-nodist": "screened",
                   "greedy-nodist": "nodist"}.get(case)


def test_spec_policy_explicit_draft_and_headroom():
    for case, want in (("explicit", "adaptive"), ("explicit-unknown", None),
                       ("no-headroom", None), ("headroom", "screened")):
        assert _policy_pick_equals_the_reference(case) == want
    pol = SpecPolicy(drafts=("screened",))
    tight = ServeRequest(prompt=np.zeros(10, np.int32), max_new=10)
    assert pol.draft_len_for(tight, max_len=20) == 1
    r8 = ServeRequest(prompt=np.zeros(4, np.int32), max_new=8, draft_len=8)
    assert pol.draft_len_for(r8, max_len=100) == 8
    assert pol.controller_for(4).n_max == 4
    assert SpecPolicy(adaptive=False).controller_for(4) is None


def test_spec_step_flops_charges_both_heads():
    cat = _cat(**{"exact": (100.0, {}), "screened": (10.0, {})})
    assert spec_step_flops(cat, "screened", "exact") == 110.0
    assert spec_step_flops(cat, "screened", "exact") > \
        head_flops(cat, "exact")


def test_request_spec_field_validation():
    ok = ServeRequest(prompt=np.zeros(4, np.int32), max_new=4,
                      draft_head="screened", draft_len=4)
    assert ok.draft_head == "screened" and ok.draft_len == 4
    with pytest.raises(ValueError, match="draft_len"):
        ServeRequest(prompt=np.zeros(4, np.int32), max_new=4, draft_len=0)
    with pytest.raises(ValueError, match="draft_head"):
        ServeRequest(prompt=np.zeros(4, np.int32), max_new=4,
                     head="screened", draft_head="screened")


# -- dist_logits --------------------------------------------------------------

@pytest.fixture(scope="module")
def tile_heads():
    """A 300-word vocab (the last 128-word tile holds 44 words) with a
    block screen whose clusters hold 1–3 tiles, one sentinel-padded, in
    both packages."""
    rng = np.random.default_rng(8)
    V, d, r = 300, 24, 4
    W = (rng.standard_normal((V, d)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    v = (rng.standard_normal((r, d)) * 3).astype(np.float32)
    mask = np.array([[1, 0, 1], [0, 1, 0], [1, 1, 1], [0, 0, 1]], bool)
    idx, lens = candidates_to_padded(mask, V, block=128)
    jscreen = JScreen(v=jnp.asarray(v), cand_idx=jnp.asarray(idx),
                      cand_len=jnp.asarray(lens), vocab_size=V, block=128)
    tscreen = screen_from_numpy(v, idx, lens, V, 128)
    h = (rng.standard_normal((32, d)) * 2).astype(np.float32)
    words = np.repeat(mask, 128, axis=1)[:, :V]
    return dict(W=W, b=b, v=v, h=h, words=words, jscreen=jscreen,
                tscreen=tscreen)


@pytest.mark.parametrize("tname,jname", [
    ("exact", "exact"), ("screened", "screened"),
    ("screened-cuda", "screened-pallas")])
def test_dist_logits_match_the_reference(tile_heads, tname, jname):
    t = tile_heads
    th = heads.get(tname, W=torch.from_numpy(t["W"]),
                   b=torch.from_numpy(t["b"]), screen=t["tscreen"],
                   device="cpu")
    jh = jheads.get(jname, W=t["W"], b=t["b"], screen=t["jscreen"])
    assert th.supports_dist and th.describe()["supports_dist"]
    got = th.dist_logits(torch.from_numpy(t["h"])).numpy()
    want = np.asarray(jh.dist_logits(t["h"]))
    assert got.shape == want.shape == (32, 300) and got.dtype == np.float32
    on, jon = got > NEG_INF / 2, want > NEG_INF / 2
    np.testing.assert_array_equal(on, jon)
    np.testing.assert_allclose(np.where(on, got, 0.0),
                               np.where(on, want, 0.0), rtol=1e-5, atol=1e-5)
    assert (got[~on] == np.float32(NEG_INF)).all()
    if tname != "exact":
        # the support is the routed cluster's candidate words < V
        cluster = (t["h"] @ t["v"].T).argmax(-1)
        np.testing.assert_array_equal(on, t["words"][cluster])


@pytest.mark.parametrize("fused", [True, False])
def test_screened_cuda_samples_inside_its_dist_support(tile_heads, fused):
    t = tile_heads
    th = heads.get("screened-cuda", W=torch.from_numpy(t["W"]),
                   b=torch.from_numpy(t["b"]), screen=t["tscreen"],
                   fused=fused, device="cpu")
    h = torch.from_numpy(t["h"])
    on = th.dist_logits(h) > NEG_INF / 2
    g = torch.Generator().manual_seed(0)
    for top_p in (1.0, 0.9):
        for _ in range(20):
            ids = th.sample(h, 1.0, top_p, generator=g).long()
            assert on[torch.arange(32), ids].all()


def test_dist_logits_matches_sampling_support(lstm):
    """exact's rows are the raw full-vocab logits; a screened head's are
    NEG_INF exactly off the routed candidate set and the exact logits on
    it; argmax over them is the head's greedy choice."""
    teng, _ = _engines(lstm)
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, lstm["tmodel"].cfg.d_model)).astype(np.float32))
    pe = teng.resolve_head("exact").dist_logits(h)
    torch.testing.assert_close(pe, h @ teng.W.T + teng.b, rtol=1e-5,
                               atol=1e-5)
    cluster = (h.numpy() @ lstm["v"].T).argmax(-1)
    for name in ("screened", "screened-cuda"):
        hd = teng.resolve_head(name)
        ps = hd.dist_logits(h)
        on = (ps > NEG_INF / 2).numpy()
        np.testing.assert_array_equal(on, lstm["word_mask"][cluster])
        torch.testing.assert_close(torch.where(torch.from_numpy(on), ps, 0.),
                                   torch.where(torch.from_numpy(on), pe, 0.),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(ps.argmax(1).numpy(),
                                      hd.next(h).numpy())
    with pytest.raises(NotImplementedError, match="supports_dist"):
        heads.get("svd", W=teng.W, b=teng.b, device="cpu").dist_logits(h)


# -- SpecDecodeStream ---------------------------------------------------------

def test_spec_stream_greedy_parity_lstm(lstm):
    """Greedy spec tokens equal the reference's SpecDecodeStream's and the
    port's plain exact generate bit for bit, with the reference's round
    counters; the engine caches one spec-verify step; a second stream of
    the same shape is lent the same slab."""
    teng, jeng = _engines(lstm)
    ps = prompts(lstm, 3, 6, seed=42)
    base = teng.generate(ps, 10, head="exact").tokens
    s1 = teng.open_spec_stream("screened-cuda", "exact", width=4,
                               draft_len=4)
    got = _run_stream(s1, [ServeRequest(prompt=p, max_new=10) for p in ps])
    js = jeng.open_spec_stream("screened", "exact", width=4, draft_len=4)
    want = _run_stream(js, [JRequest(prompt=p, max_new=10) for p in ps])
    ts = teng.open_spec_stream("screened", "exact", width=4, draft_len=4)
    got_s = _run_stream(ts, [ServeRequest(prompt=p, max_new=10) for p in ps])
    for i in range(3):
        assert_decided(lstm, ps[i], base[i], screened=False)
        np.testing.assert_array_equal(got[i], base[i])
        np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_array_equal(got_s[i], want[i])
    assert ts.spec_counters() == js.spec_counters()
    assert s1.spec_counters()["emitted"] == 27
    c = s1.spec_counters()
    assert c["drafted"] > c["accepted"]            # rejections happened
    assert s1.restored_rows > 0
    assert ("exact", "spec-verify") in teng.compiled_step_counts()
    assert (teng.resolve_head("exact").step_key(), "spec-verify", 4) in \
        teng._step_cache
    # the slab (and so, on the card, its graphs) goes to the next stream
    s2 = teng.open_spec_stream("screened-cuda", "exact", width=4,
                               draft_len=4)
    s2.join(ServeRequest(prompt=ps[0], max_new=3))
    key = (4, s2._slab_key())
    assert s2._slab.spec.H.shape == (4, 4, lstm["tmodel"].cfg.d_model)
    slab = s2._slab
    while not s2.idle:
        s2.step()
    assert [r() for r in teng._free_stream_slabs[key]] == [slab]


def test_spec_stream_hybrid_rollback_parity(hybrid):
    """zamba2-2.7b (reduced): snapshot restore of the SSM states and conv
    tails from the ring, the K/V caches left unrestored, under heavy
    rejection: tokens equal the reference's and plain exact generate."""
    teng, jeng = _engines(hybrid, max_len=40)
    ps = prompts(hybrid, 2, 17, seed=5)
    base = teng.generate(ps, 8, head="exact").tokens
    ts = teng.open_spec_stream("screened", "exact", width=3, draft_len=3)
    got = _run_stream(ts, [ServeRequest(prompt=p, max_new=8) for p in ps])
    js = jeng.open_spec_stream("screened", "exact", width=3, draft_len=3)
    want = _run_stream(js, [JRequest(prompt=p, max_new=8) for p in ps])
    for i in range(2):
        assert_decided(hybrid, ps[i], base[i], screened=False)
        np.testing.assert_array_equal(got[i], base[i])
        np.testing.assert_array_equal(got[i], want[i])
    c = ts.spec_counters()
    assert c == js.spec_counters()
    assert c["accepted"] < c["drafted"] and ts.restored_rows > 0


def test_spec_stream_transformer_rollback_parity():
    """smollm-360m (reduced; the reference's fixture): attention-family
    rollback is position masking alone — no snapshot ring on the slab, no
    row restored — and parity holds under heavy rejection: tokens equal
    plain exact generate's and the reference spec stream's."""
    dense = dense_fx("smollm-360m")
    teng, jeng = _engines(dense, max_len=40)
    ps = prompts(dense, 3, 6, seed=5)
    base = teng.generate(ps, 10, head="exact").tokens
    ts = teng.open_spec_stream("screened", "exact", width=4, draft_len=3)
    got = _run_stream(ts, [ServeRequest(prompt=p, max_new=10) for p in ps])
    js = jeng.open_spec_stream("screened", "exact", width=4, draft_len=3)
    want = _run_stream(js, [JRequest(prompt=p, max_new=10) for p in ps])
    for i in range(3):
        assert_decided(dense, ps[i], base[i], screened=False)
        np.testing.assert_array_equal(got[i], base[i])
        np.testing.assert_array_equal(got[i], want[i])
    c = ts.spec_counters()
    assert c == js.spec_counters()
    assert c["accepted"] < c["drafted"]           # rejections really happened
    assert ts.restored_rows == 0 and not ts._snapshot
    ts.join(ServeRequest(prompt=ps[0], max_new=3))
    assert ts._slab.spec.ring == [] and ts._slab.spec.ring_nbytes == 0


def test_spec_stream_adaptive_controller_shrinks(hybrid):
    """The random screen's acceptance collapses → the controller walks the
    live draft length down, the shapes (and tokens) unchanged."""
    teng, _ = _engines(hybrid, max_len=40)
    ps = prompts(hybrid, 2, 5, seed=6)
    st = teng.open_spec_stream("screened", "exact", width=2, draft_len=4)
    got = _run_stream(st, [ServeRequest(prompt=p, max_new=12) for p in ps])
    assert st.controller is not None and st.controller.n < 4
    base = teng.generate(ps, 12, head="exact").tokens
    for i in range(2):
        np.testing.assert_array_equal(got[i], base[i])


def test_spec_stream_guard_rolls_the_round_back(lstm):
    """A fault at the verify boundary undoes the whole round (ring slot 0,
    generator state): the retried stream gives the fault-free tokens."""
    teng, _ = _engines(lstm)
    ps = prompts(lstm, 2, 6, seed=7)
    reqs = [ServeRequest(prompt=p, max_new=9) for p in ps]
    clean = _run_stream(teng.open_spec_stream("screened", "exact", width=2,
                                              draft_len=3), reqs)
    s = teng.open_spec_stream("screened", "exact", width=2, draft_len=3)
    inj = FaultInjector(seed=0)
    inj.arm("verify", "transient", count=2, after=1)
    s.fault_injector = inj
    for i, r in enumerate(reqs):
        s.join(r, tag=i)
    done, faults = {}, 0
    while not s.idle:
        try:
            out = s.step()
        except HeadFault:
            faults += 1
            continue
        done.update({t: toks for t, _, toks in out})
    assert faults == 2
    for i in range(2):
        np.testing.assert_array_equal(done[i], clean[i])


def test_spec_stream_sampled_smoke(lstm):
    teng, _ = _engines(lstm)
    ps = prompts(lstm, 2, 6, seed=11)
    reqs = [ServeRequest(prompt=p, max_new=8, temperature=0.8, top_p=0.9,
                         seed=3) for p in ps]
    runs = []
    for draft in ("screened-cuda", "screened-cuda", "screened"):
        s = teng.open_spec_stream(draft, "exact", width=2, draft_len=3,
                                  temperature=0.8, top_p=0.9, seed=3)
        runs.append(_run_stream(s, reqs))
    for i in range(2):
        assert runs[0][i].shape == (8,)
        assert 0 <= runs[0][i].min() and runs[0][i].max() < lstm["vocab"]
        np.testing.assert_array_equal(runs[0][i], runs[1][i])   # one seed
    assert ("screened-cuda", "spec-dist") in teng.compiled_step_counts()
    with pytest.raises(ValueError, match="DISTINCT"):
        teng.open_spec_stream("exact", "exact")
    svd = heads.get("svd", W=teng.W, b=teng.b, device="cpu")
    with pytest.raises(ValueError, match="dist_logits"):
        teng.open_spec_stream(svd, "exact", temperature=0.8)


def test_spec_stream_join_headroom_and_width(lstm):
    teng = DecodeEngine(lstm["tmodel"], lstm["tparams"],
                        screen=lstm["tscreen"], max_len=16, device="cpu")
    stream = teng.open_spec_stream("screened", "exact", width=2, draft_len=4)
    with pytest.raises(ValueError, match="overshoot"):
        stream.join(ServeRequest(prompt=np.zeros(8, np.int32), max_new=6))
    stream.join(ServeRequest(prompt=np.zeros(8, np.int32), max_new=5))
    with pytest.raises(ValueError, match="width"):
        teng.open_spec_stream("screened", "exact", width=0)


def test_spec_stream_kv_pool_reservations(lstm):
    teng, _ = _engines(lstm, max_len=32)
    pool = PagePool(num_pages=32, page_size=4)
    stream = teng.open_spec_stream("screened", "exact", width=2,
                                   draft_len=4, kv_pool=pool)
    req = ServeRequest(prompt=prompts(lstm, 1, 6, seed=1)[0], max_new=6)
    stream.join(req, tag=0)
    assert pool.pages_in_use == 4                  # ceil((6 + 6 + 3) / 4)
    while not stream.idle:
        stream.step()
    assert pool.pages_in_use == 0
    tiny = PagePool(num_pages=2, page_size=4)
    s2 = teng.open_spec_stream("screened", "exact", width=2, draft_len=4,
                               kv_pool=tiny)
    with pytest.raises(PoolExhausted):
        s2.join(req, tag=0)
    assert tiny.pages_in_use == 0 and s2.n_active == 0


# -- scheduler integration ----------------------------------------------------

# the fixture's screen holds 320 of 512 words on average, so its flops
# advantage over exact is below SpecPolicy's default min_ratio of 2
def test_scheduler_spec_parity_and_stats(lstm):
    """ContinuousScheduler(spec=...) serves exact-routed traffic on spec
    lanes: results equal plain serve_batch and the reference's scheduler
    (composite head names), and ServerStats' spec section equals the
    reference's."""
    teng, jeng = _engines(lstm, max_len=32)
    ps = prompts(lstm, 6, 6, seed=21)
    outs, snaps = [], []
    for eng, sched, req, static, pol in (
            (teng, ContinuousScheduler, ServeRequest, StaticPolicy,
             SpecPolicy), (jeng, JSched, JRequest, JStatic, JSpecPolicy)):
        reqs = [req(prompt=p, max_new=6 + (i % 3)) for i, p in enumerate(ps)]
        s = sched(eng, policy=static("exact"),
                  spec=pol(drafts=("screened",), draft_len=4,
                           min_ratio=1.0))
        outs.append([outcome(r) for r in s.serve(reqs)])
        snaps.append(s.stats.snapshot())
    assert outs[0] == outs[1]
    base = teng.serve_batch([ServeRequest(prompt=p, max_new=6 + (i % 3))
                             for i, p in enumerate(ps)],
                            policy=StaticPolicy("exact"))
    for o, b in zip(outs[0], base):
        assert o[1] == "exact+spec[screened]" and o[2] == b.tokens.tolist()
    spec, jspec = snaps[0]["spec"], snaps[1]["spec"]
    assert spec == jspec and spec["rounds"] > 0
    assert snaps[0]["tokens"] == sum(len(b.tokens) for b in base)
    text = snaps[0]
    assert text["spec"]["accepted_tokens_per_step"] > 1.0


def test_scheduler_drops_draft_before_head(lstm):
    teng, _ = _engines(lstm, max_len=32)
    cat = teng.head_catalog(("exact", "screened"))
    tight = head_flops(cat, "exact") + 0.5 * head_flops(cat, "screened")
    p = prompts(lstm, 1, 6, seed=2)[0]
    sched = ContinuousScheduler(
        teng, policy=StaticPolicy("exact"),
        admission=BudgetAdmission(flops_budget=tight),
        spec=SpecPolicy(drafts=("screened",), min_ratio=1.0))
    sched.submit(ServeRequest(prompt=p, max_new=4))
    qr = next(iter(sched.queue))
    assert qr.head == "exact" and qr.draft is None
    assert sched.stats.downgraded == 0
    roomy = ContinuousScheduler(
        teng, policy=StaticPolicy("exact"),
        admission=BudgetAdmission(flops_budget=10 * tight),
        spec=SpecPolicy(drafts=("screened",), draft_len=4,
                        min_ratio=1.0))
    roomy.submit(ServeRequest(prompt=p, max_new=4))
    qr = next(iter(roomy.queue))
    assert qr.draft == "screened" and qr.draft_len == 4
    assert qr.cost == pytest.approx(spec_step_flops(cat, "screened",
                                                    "exact"))


def test_scheduler_spec_lane_signature(lstm):
    teng, _ = _engines(lstm, max_len=32)
    sched = ContinuousScheduler(
        teng, policy=StaticPolicy("exact"),
        spec=SpecPolicy(drafts=("screened",), draft_len=4,
                        min_ratio=1.0))
    p = prompts(lstm, 2, 6, seed=5)
    sched.submit(ServeRequest(prompt=p[0], max_new=4))
    sched.submit(ServeRequest(prompt=p[1], max_new=4, draft_len=1))
    assert len({sched._sig(qr) for qr in sched.queue}) == 2
    assert sorted(r.head for r in sched.drain()) == \
        ["exact", "exact+spec[screened]"]


def test_scheduler_breaker_trips_the_draft_alone(lstm):
    """A permanent fault on the DRAFT head strips the draft: the request
    finishes plain on its verify head, with the same tokens."""
    teng, _ = _engines(lstm, max_len=32)
    ps = prompts(lstm, 3, 6, seed=9)
    reqs = [ServeRequest(prompt=p, max_new=6) for p in ps]
    base = teng.serve_batch(reqs, policy=StaticPolicy("exact"))
    inj = FaultInjector(seed=0)
    inj.arm("draft", "permanent", head="screened", count=1)
    sched = ContinuousScheduler(
        teng, policy=StaticPolicy("exact"), fault_injector=inj,
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=1e9,
                               clock=LogicalClock()),
        spec=SpecPolicy(drafts=("screened",), draft_len=3,
                        min_ratio=1.0))
    out = sched.serve(reqs)
    for r, b in zip(out, base):
        assert isinstance(r, ServeResult)
        np.testing.assert_array_equal(r.tokens, b.tokens)
    assert sched.stats.snapshot()["resilience"]["spec_degraded"] >= 1
    assert any(r.head == "exact" for r in out)


def test_serve_launcher_draft_head_validation():
    """--draft-head combos exit 2 before any training, as the reference's
    do."""
    base = ["--arch", "ptb-small-lstm", "--reduced"]
    for argv in (["--scheduler", "--draft-head", "nope"],
                 ["--draft-head", "screened", "--l2s"],
                 ["--scheduler", "--draft-head", "exact"],
                 ["--scheduler", "--draft-head", "screened"],
                 ["--scheduler", "--draft-head", "screened-cuda"]):
        want = jserve.main(base + [a.replace("screened-cuda",
                                             "screened-pallas")
                                   for a in argv])
        assert tserve.main(base + ["--device", "cpu"] + argv) == want == 2
