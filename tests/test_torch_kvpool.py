"""The port's paged KV pool (``repro_torch.serving.kvpool``) against the JAX
package's, on the CPU, on the same weights (``torch_serving_fixtures``):

  * ``PagePool`` and ``RadixCache`` driven through the same operation
    sequences give the reference's page ids, refcounts, matches, payloads
    and telemetry; the refcount invariants hold under random sequences
    (hypothesis), step by step equal to the reference's pool;
  * ``bind`` takes the LSTM family, builds the dense family's device page
    store (the reference's shape, the engine's cache dtype), and refuses
    the others;
  * ``PagedDecodeStream`` tokens equal the reference's and solo
    ``generate``'s bit for bit, with the same radix hits, page ids and
    copy-on-write counts, for the LSTM and (reduced smollm-360m, the
    reference's fixture) the dense family, whose stale page rows,
    poisoned, never leak; a join the pool cannot back rolls back; a
    sampled paged stream equals a plain stream;
  * radix payloads never alias the stream's slab: a second join on a
    cached prefix, after the first stream has decoded, gets the same
    tokens, and the payload tensors are untouched;
  * ``ContinuousScheduler(kv_pool=...)``: drains, pool pressure (typed
    preemption), marginal-page pricing with the resident-prefix discount,
    and a drain with ``kv_pool=`` and ``spec=`` — outcomes and pool stats
    equal the reference's.

Greedy tokens are held equal where the reference's steps are decided by a
top-2 gap above 1e-4 (asserted).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.serving import BudgetAdmission as JBudget
from repro.serving import ContinuousScheduler as JSched
from repro.serving import DecodeEngine as JEngine
from repro.serving import PagePool as JPool
from repro.serving import PoolExhausted as JPoolExhausted
from repro.serving import ServeRequest as JRequest
from repro.serving import SpecPolicy as JSpecPolicy
from repro.serving import StaticPolicy as JStatic
from repro.serving.kvpool import RadixCache as JRadix
from repro.serving.kvpool.radix import MAX_PARTIALS as J_MAX_PARTIALS
from repro_torch.serving import (BudgetAdmission, ContinuousScheduler,
                                 DecodeEngine, PagePool, PoolExhausted,
                                 ServeRequest, ServeResult, SpecPolicy,
                                 StaticPolicy)
from repro_torch.serving.kvpool import TRASH_PAGE, RadixCache
from repro_torch.serving.kvpool.radix import MAX_PARTIALS
from repro_torch.serving.scheduler import AdmissionRejected
from repro_torch.tree import tree_leaves
from torch_serving_fixtures import (assert_decided, dense_fx, hybrid_fx,
                                    lstm_fx, outcome)


@pytest.fixture(scope="module")
def lstm():
    return lstm_fx()


def _engines(fx, max_len=24):
    teng = DecodeEngine(fx["tmodel"], fx["tparams"], screen=fx["tscreen"],
                        max_len=max_len, device="cpu")
    jeng = JEngine(fx["jmodel"], fx["jparams"], screen=fx["jscreen"],
                   max_len=max_len)
    return teng, jeng


def _prefix_prompts(fx, n, template_len=10, suffix_len=3, seed=0):
    rng = np.random.default_rng(seed)
    tmpl = rng.integers(0, fx["vocab"], size=template_len)
    return [np.concatenate([tmpl, rng.integers(0, fx["vocab"],
                                               size=suffix_len)]
                           ).astype(np.int32) for _ in range(n)]


def _run_stream(stream, requests):
    got, pending = {}, list(enumerate(requests))
    while pending or stream.n_active or stream._finished:
        while pending and stream.free_slots:
            i, r = pending.pop(0)
            stream.join(r, tag=i)
        for tag, _, toks in stream.step():
            got[tag] = toks
    return got


def _both(fn):
    """``fn(PagePool, RadixCache, PoolExhausted)`` on each package."""
    return (fn(PagePool, RadixCache, PoolExhausted),
            fn(JPool, JRadix, JPoolExhausted))


# -- PagePool unit ------------------------------------------------------------

def test_pool_alloc_release_refcounts():
    def run(Pool, _, __):
        pool = Pool(6, 4)
        a, b = pool.alloc(), pool.alloc()
        trace = [a, b, pool.pages_in_use, pool.writable(a)]
        pool.retain(a)
        trace += [pool.ref(a), pool.writable(a)]
        pool.release(a)
        pool.release(a)
        trace += [pool.ref(a), pool.pages_free]
        with pytest.raises(ValueError, match="double free"):
            pool.release(a)
        with pytest.raises(ValueError):
            pool.retain(a)
        pool.release(b)
        return trace + [pool.pages_in_use, pool.peak_in_use]
    got, want = _both(run)
    assert got == want and got[0] != TRASH_PAGE and got[:2] == [1, 2]


def test_pool_cow_and_ensure_writable():
    def run(Pool, _, __):
        pool = Pool(6, 4)
        a = pool.alloc()
        out = [pool.ensure_writable(a)]
        pool.retain(a)
        c = pool.ensure_writable(a)
        return out + [c, pool.ref(a), pool.ref(c), pool.cow_copies,
                      pool.cow(pool.retain(c)), pool.live_pages()]
    got, want = _both(run)
    assert got == want and got[1] != got[0] and got[4] == 1


def test_pool_exhaustion_typed():
    def run(Pool, _, Exhausted):
        pool = Pool(3, 4)
        pool.alloc(), pool.alloc()
        with pytest.raises(Exhausted) as ei:
            pool.alloc()
        return (ei.value.needed, ei.value.free, ei.value.total,
                str(ei.value))
    got, want = _both(run)
    assert got == want == (1, 0, 2, want[3]) and "exhausted" in got[3]


def test_pool_validation():
    for Pool in (PagePool, JPool):
        with pytest.raises(ValueError):
            Pool(1, 4)
        with pytest.raises(ValueError):
            Pool(4, 0)


@given(st.integers(2, 12), st.integers(1, 8), st.data())
@settings(max_examples=60, deadline=None)
def test_page_pool_refcount_invariants(num_pages, page_size, data):
    """Random alloc/retain/release/cow/ensure_writable sequences, and page
    chains a faulted transaction rolls back, against a model of held
    references: no double free, no refcount leak, pages-in-use equal to the
    distinct live pages — and after every operation the reference's pool,
    driven the same way, holds the same pages with the same refcounts."""
    from collections import Counter
    pool, jpool = PagePool(num_pages, page_size), JPool(num_pages, page_size)

    def both(op, *args):
        out = []
        for p, exc in ((pool, PoolExhausted), (jpool, JPoolExhausted)):
            try:
                out.append(getattr(p, op)(*args))
            except exc:
                out.append("exhausted")
        assert out[0] == out[1], (op, args, out)
        return out[0]

    held = []
    for _ in range(data.draw(st.integers(1, 60), label="n_ops")):
        op = data.draw(st.sampled_from(
            ["alloc", "retain", "release", "cow", "ensure_writable",
             "faulted_txn"]), label="op")
        if op == "alloc":
            pg = both("alloc")
            if pg == "exhausted":
                assert not pool.pages_free
            else:
                held.append(pg)
        elif op == "faulted_txn":
            taken = []
            for _ in range(data.draw(st.integers(1, 3), label="chain")):
                pg = both("alloc")
                if pg == "exhausted":
                    assert not pool.pages_free
                    break
                taken.append(pg)
            if data.draw(st.booleans(), label="fault"):
                for pg in reversed(taken):          # HeadFault: rollback
                    both("release", pg)
            else:
                held.extend(taken)
        elif not held:
            continue
        else:
            i = data.draw(st.integers(0, len(held) - 1), label="ref")
            if op == "retain":
                held.append(both("retain", held[i]))
            elif op == "release":
                both("release", held.pop(i))
            else:
                old = held[i]
                was_sole = held.count(old) == 1
                new = both(op, old)
                if new == "exhausted":
                    assert not pool.pages_free
                    assert op == "cow" or not was_sole
                else:
                    held[i] = new
                    if op == "ensure_writable":
                        assert (new == old) == was_sole
        model = Counter(held)
        assert TRASH_PAGE not in model
        assert pool.live_pages() == dict(model) == jpool.live_pages()
        assert pool.pages_in_use == len(model)
        assert pool.pages_free + pool.pages_in_use == num_pages - 1
        assert pool.peak_in_use == jpool.peak_in_use >= pool.pages_in_use
        for pg in model:
            assert pool.writable(pg) == (model[pg] == 1)
    seen = set(held)
    for pg in held:
        pool.release(pg)
    assert pool.pages_in_use == 0 and pool.pages_free == num_pages - 1
    for pg in seen:
        with pytest.raises(ValueError, match="double free"):
            pool.release(pg)


# -- RadixCache unit ----------------------------------------------------------

def test_radix_insert_match_roundtrip():
    def run(Pool, Radix, _):
        pool = Pool(32, 4)
        radix = Radix(pool)
        toks = list(range(10))
        pages = [pool.alloc() for _ in range(3)]
        out = [radix.insert(toks, pages, payloads=["s0", "s1", "s2"]),
               radix.nodes, [pool.ref(pg) for pg in pages]]
        for q in (toks, toks[:9], list(range(8)) + [99, 98], [7, 7]):
            m = radix.match(q)
            out.append((m.n_tokens, m.n_full, m.chain, m.tail, m.payload))
        out.append(radix.match(toks, peek=True).n_full)
        return out + [radix.telemetry()]
    got, want = _both(run)
    assert got == want
    assert got[3] == (10, 10, [(1, 4), (2, 4), (3, 2)], None, "s2")
    assert got[4][:2] == (9, 8) and got[4][3] == (3, 1)


def test_radix_reclaim_skips_shared_pages():
    def run(Pool, Radix, _):
        pool = Pool(32, 4)
        radix = Radix(pool)
        pages = [pool.alloc(), pool.alloc()]
        radix.insert(list(range(8)), pages)
        for pg in pages:
            pool.release(pg)
        pool.retain(pages[1])
        out = [radix.reclaim(2), radix.evictable_pages()]
        pool.release(pages[1])
        return out + [radix.reclaim(2), radix.nodes, pool.pages_in_use,
                      radix.evictions]
    got, want = _both(run)
    assert got == want == [0, 1, 2, 0, 0, 2]


def test_radix_partials_lru_capped():
    assert MAX_PARTIALS == J_MAX_PARTIALS

    def run(Pool, Radix, _):
        pool = Pool(64, 4)
        radix = Radix(pool)
        for i in range(MAX_PARTIALS + 3):
            pages = [pool.alloc()]
            radix.insert([100 + i, 200 + i], pages)
            pool.release(pages[0])
        return [radix.nodes, radix.evictions, sorted(pool.live_pages())]
    got, want = _both(run)
    assert got == want and got[:2] == [MAX_PARTIALS, 3]


def test_radix_clear_and_hit_accounting():
    def run(Pool, Radix, _):
        pool = Pool(16, 4)
        radix = Radix(pool)
        pages = [pool.alloc() for _ in range(3)]
        radix.insert(list(range(12)), pages)
        radix.record(8, 12)
        radix.record(0, 5)
        out = [radix.hit_rate, radix.telemetry()]
        for pg in pages:
            pool.release(pg)
        return out + [radix.clear(), pool.pages_in_use]
    got, want = _both(run)
    assert got == want and got[-2:] == [3, 0]


def test_bind_requires_page_alignment(lstm):
    teng, _ = _engines(lstm)
    with pytest.raises(ValueError, match="must divide"):
        teng.open_paged_stream(PagePool(8, 7))
    pool = PagePool(8, 4)
    pool.bind(teng)
    pool.bind(teng)                                 # idempotent
    with pytest.raises(ValueError, match="another engine"):
        pool.bind(_engines(lstm)[0])
    assert pool.bytes_per_page() == 2 * 2 * 128 * 4    # 2 layers, d = 128


def test_bind_refuses_the_other_families():
    """The hybrid and a sliding-window moe (as in the reference) raise
    NotImplementedError; moe without a window binds
    (tests/test_torch_moe.py)."""
    hyb = hybrid_fx()
    heng = DecodeEngine(hyb["tmodel"], hyb["tparams"], max_len=24,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="lstm"):
        heng.open_paged_stream(PagePool(8, 4))

    class _Cfg:
        name, family, sliding_window = "moe-stub", "moe", 64

    class _Stub:
        max_len = 24
        model = type("M", (), {"cfg": _Cfg})
    with pytest.raises(NotImplementedError, match="sliding-window"):
        PagePool(8, 4).bind(_Stub)


@pytest.fixture(scope="module")
def dense():
    return dense_fx("smollm-360m")


def test_bind_builds_the_dense_page_store(dense):
    """``bind`` on a dense engine builds a ``PagedKVStore`` of (L, N_pages,
    P, KV, hd) in the engine's cache dtype, as the reference's does, and
    the telemetry reports its bytes."""
    for dtype, jdtype in ((torch.float32, "float32"),
                          (torch.bfloat16, "bfloat16")):
        teng = DecodeEngine(dense["tmodel"], dense["tparams"], max_len=24,
                            cache_dtype=dtype, device="cpu")
        jeng = JEngine(dense["jmodel"], dense["jparams"], max_len=24,
                       cache_dtype=getattr(jnp, jdtype))
        tpool, jpool = PagePool(8, 4), JPool(8, 4)
        tpool.bind(teng)
        jpool.bind(jeng)
        assert tuple(tpool.store.k.shape) == jpool.store.k.shape
        assert tpool.store.k.dtype == tpool.store.v.dtype == dtype
        assert tpool.store.k.device == teng.device
        assert tpool.telemetry() == jpool.telemetry()
        assert tpool.bytes_per_page() == jpool.bytes_per_page() > 0


def test_dense_paged_stream_parity(dense):
    """Four requests sharing an 8-token prefix on pages of 4: tokens equal
    solo ``generate``'s and the reference's paged stream's bit for bit,
    the same pool and radix telemetry, full prompt pages deduped, and the
    decode ran the paged steps."""
    ps = _prefix_prompts(dense, 4, template_len=8, suffix_len=4, seed=3)
    teng, tpool, jpool, got, want = _paged_both(dense, ps, 4, 2)
    for i, p in enumerate(ps):
        ref = teng.generate(p[None], 4).tokens[0]
        assert_decided(dense, p, ref, screened=False)
        np.testing.assert_array_equal(got[i], ref)
        np.testing.assert_array_equal(got[i], want[i])
    assert tpool.telemetry() == jpool.telemetry()
    assert tpool.live_pages() == jpool.live_pages()
    assert tpool.radix.hit_rate > 0.3          # full prompt pages deduped
    assert ("exact", "greedy-paged") in teng.compiled_step_counts()


def test_dense_stale_page_rows_never_leak(dense):
    """Poison every page with large finite junk after a first round, then
    decode on reused pages (the pool's LIFO free list hands the poisoned
    pages out first): the paged keep-mask zeroes the stale rows exactly,
    so tokens equal solo ``generate``'s bit for bit."""
    teng, _ = _engines(dense)
    pool = PagePool(16, 4)
    stream = teng.open_paged_stream(pool, width=2)
    reqs1 = [ServeRequest(prompt=p, max_new=4) for p in
             _prefix_prompts(dense, 2, template_len=8, suffix_len=4, seed=7)]
    _run_stream(stream, reqs1)
    pool.radix.clear()
    assert pool.pages_in_use == 0
    pool.store.k[:, 1:] = 1e3
    pool.store.v[:, 1:] = 1e3
    reqs2 = [ServeRequest(prompt=p, max_new=5) for p in
             _prefix_prompts(dense, 3, template_len=8, suffix_len=4,
                             seed=11)]
    got = _run_stream(stream, reqs2)
    for i, r in enumerate(reqs2):
        ref = teng.generate(r.prompt[None], r.max_new).tokens[0]
        np.testing.assert_array_equal(got[i], ref)


# -- paged stream -------------------------------------------------------------

def _paged_both(fx, prompts_, max_new, width, num_pages=64, page_size=4,
                max_len=24):
    teng, jeng = _engines(fx, max_len=max_len)
    tpool, jpool = PagePool(num_pages, page_size), JPool(num_pages,
                                                         page_size)
    got = _run_stream(teng.open_paged_stream(tpool, width=width),
                      [ServeRequest(prompt=p, max_new=max_new)
                       for p in prompts_])
    want = _run_stream(jeng.open_paged_stream(jpool, width=width),
                       [JRequest(prompt=p, max_new=max_new)
                        for p in prompts_])
    return teng, tpool, jpool, got, want


def test_lstm_paged_stream_parity_and_hits(lstm):
    ps = _prefix_prompts(lstm, 6, seed=3)
    teng, tpool, jpool, got, want = _paged_both(lstm, ps, 5, 3)
    for i, p in enumerate(ps):
        ref = teng.generate(p[None], 5).tokens[0]
        assert_decided(lstm, p, ref, screened=False)
        np.testing.assert_array_equal(got[i], ref)
        np.testing.assert_array_equal(got[i], want[i])
    assert tpool.telemetry() == jpool.telemetry()
    assert tpool.live_pages() == jpool.live_pages()
    assert tpool.radix.hit_rate > 0.3 and tpool.cow_copies > 0
    assert tpool.pages_in_use == tpool.radix.nodes
    assert all(kind == "greedy" for _, kind in teng.compiled_step_counts())


def test_lstm_mixed_prompt_lengths_parity(lstm):
    """Grid realignment, COW of extended partial tails, and whole-prompt
    hits (a prompt that IS a cached prefix decodes its first token from
    the snapshot's own h, with no forward pass)."""
    base = _prefix_prompts(lstm, 1, template_len=11, suffix_len=0,
                           seed=5)[0]
    ps = [base[:n] for n in (11, 7, 11, 5, 9, 11)]
    teng, tpool, jpool, got, want = _paged_both(lstm, ps, 4, 2)
    for i, p in enumerate(ps):
        ref = teng.generate(p[None], 4).tokens[0]
        np.testing.assert_array_equal(got[i], ref)
        np.testing.assert_array_equal(got[i], want[i])
    assert tpool.telemetry() == jpool.telemetry()


def test_join_rolls_back_on_exhaustion(lstm):
    teng, _ = _engines(lstm)
    pool = PagePool(3, 4)
    stream = teng.open_paged_stream(pool, width=2)
    rng = np.random.default_rng(9)
    big = ServeRequest(prompt=rng.integers(0, lstm["vocab"], 14),
                       max_new=4)
    with pytest.raises(PoolExhausted):
        stream.join(big)
    assert pool.pages_in_use == 0
    assert stream.n_active == 0 and stream.pages_held == 0
    small = ServeRequest(prompt=rng.integers(0, lstm["vocab"], 4), max_new=3)
    got = _run_stream(stream, [small])
    np.testing.assert_array_equal(
        got[0], teng.generate(small.prompt[None], 3).tokens[0])


def test_lstm_paged_sampled_stream_matches_unpaged(lstm):
    teng, _ = _engines(lstm)
    reqs = [ServeRequest(prompt=p, max_new=4, temperature=0.8, top_p=0.95,
                         seed=11) for p in _prefix_prompts(lstm, 3, seed=13)]
    kw = dict(width=2, temperature=0.8, top_p=0.95, seed=11)
    plain = _run_stream(teng.open_stream(**kw), reqs)
    paged = _run_stream(teng.open_paged_stream(PagePool(64, 4), **kw), reqs)
    for i in range(len(reqs)):
        np.testing.assert_array_equal(plain[i], paged[i])


def test_radix_payloads_do_not_alias_the_slab(lstm):
    """A payload is a clone nothing writes later: after a stream decoded on
    top of a cached prefix, a second join on the same prefix resumes from
    the untouched snapshot and gets the same tokens."""
    teng, _ = _engines(lstm)
    pool = PagePool(64, 4)
    p = _prefix_prompts(lstm, 1, template_len=8, suffix_len=0, seed=3)[0]
    first = _run_stream(teng.open_paged_stream(pool, width=2),
                        [ServeRequest(prompt=p, max_new=8)])[0]
    m = pool.radix.match(p.tolist(), peek=True)
    assert m.n_full == 8 and m.payload is not None
    kept = [{k: v.clone() for k, v in layer.items()} for layer in m.payload]
    stream = teng.open_paged_stream(pool, width=2)
    stream.join(ServeRequest(prompt=p, max_new=8), tag=0)
    slab_leaves = [x.data_ptr() for x in tree_leaves(stream._slab.cache)]
    for layer in m.payload:
        assert all(v.data_ptr() not in slab_leaves for v in layer.values())
    done = {}
    while stream.n_active:
        done.update({t: toks for t, _, toks in stream.step()})
    for a, b in zip(m.payload, kept):
        assert all(torch.equal(a[k], b[k]) for k in a)
    np.testing.assert_array_equal(done[0], first)
    again = _run_stream(teng.open_paged_stream(pool, width=2),
                        [ServeRequest(prompt=p, max_new=8)])[0]
    np.testing.assert_array_equal(again, first)
    assert pool.radix.lookup_hits == 2


# -- scheduler integration ----------------------------------------------------

def _sched_both(fx, reqs_kw, make_pool, max_len=24, **kw):
    teng, jeng = _engines(fx, max_len=max_len)
    out = []
    for eng, sched, req, pool_cls, extra in (
            (teng, ContinuousScheduler, ServeRequest, PagePool,
             {k: v[0] for k, v in kw.items()}),
            (jeng, JSched, JRequest, JPool,
             {k: v[1] for k, v in kw.items()})):
        pool = make_pool(pool_cls)
        s = sched(eng, kv_pool=pool, **extra)
        res = s.serve([req(**r) for r in reqs_kw])
        out.append(([outcome(r) for r in res], s.stats.snapshot(), pool))
    return teng, out


def test_scheduler_paged_drain_parity(lstm):
    reqs = [dict(prompt=p, max_new=5)
            for p in _prefix_prompts(lstm, 6, seed=17)]
    teng, ((got, snap, pool), (want, jsnap, _)) = _sched_both(
        lstm, reqs, lambda P: P(64, 4), max_slots=(3, 3))
    assert got == want
    for o, r in zip(got, reqs):
        assert o[0] == "ServeResult"
        assert o[2] == teng.generate(r["prompt"][None], 5).tokens[0].tolist()
    assert snap["pool"] == jsnap["pool"]
    assert snap["pool"]["prefix"]["hit_rate"] > 0.3
    assert snap["pool"]["pages_in_use"] == pool.pages_in_use


def test_scheduler_pool_pressure_preempts(lstm):
    rng = np.random.default_rng(19)
    reqs = [dict(prompt=rng.integers(0, lstm["vocab"], 12), max_new=6,
                 latency_tier="batch") for _ in range(3)]
    _, ((got, snap, _), (want, jsnap, _)) = _sched_both(
        lstm, reqs, lambda P: P(6, 4), max_slots=(2, 2))
    assert got == want and len(got) == 3
    kinds = {o[0] for o in got}
    assert kinds == {"ServeResult", "AdmissionRejected"}
    assert snap["pool"] == jsnap["pool"]
    assert snap["pool"]["stalled_ticks"] > 0


def test_admission_prices_marginal_pages(lstm):
    teng, _ = _engines(lstm)
    rng = np.random.default_rng(23)
    sched = ContinuousScheduler(teng, admission=BudgetAdmission(),
                                kv_pool=PagePool(4, 4))
    res = sched.serve([ServeRequest(
        prompt=rng.integers(0, lstm["vocab"], 12), max_new=6)])
    assert isinstance(res[0], AdmissionRejected)
    assert res[0].stage == "admission" and "pool exhausted" in res[0].reason
    res2 = sched.serve([ServeRequest(
        prompt=rng.integers(0, lstm["vocab"], 6), max_new=4)])
    assert isinstance(res2[-1], ServeResult)


def test_admission_discounts_resident_prefix(lstm):
    teng, jeng = _engines(lstm)
    rng = np.random.default_rng(29)
    tmpl = rng.integers(0, lstm["vocab"], 8)
    ps = [np.concatenate([tmpl, rng.integers(0, lstm["vocab"], 4)])
          for _ in range(2)]
    got = []
    for eng, sched, req, pool, adm in (
            (teng, ContinuousScheduler, ServeRequest, PagePool,
             BudgetAdmission), (jeng, JSched, JRequest, JPool, JBudget)):
        s = sched(eng, admission=adm(), kv_pool=pool(8, 4))
        first = s.serve([req(prompt=ps[0], max_new=4)])
        got.append((type(first[0]).__name__,
                    s._marginal_pages(req(prompt=ps[1], max_new=4)),
                    s._marginal_pages(req(prompt=ps[1], max_new=4),
                                      draft_slack=3)))
    assert got[0] == got[1] == ("ServeResult", 2, 5)


def test_scheduler_paged_zero_recompiles(lstm):
    """Warm paged serving adds no step: the paged LSTM stream rides the
    dense greedy step, so a second scheduler adds nothing to the cache."""
    teng, _ = _engines(lstm)
    pool = PagePool(64, 4)
    ContinuousScheduler(teng, max_slots=3, kv_pool=pool).serve(
        [ServeRequest(prompt=p, max_new=3)
         for p in _prefix_prompts(lstm, 3, seed=31)])
    keys = list(teng._step_cache)
    res = ContinuousScheduler(teng, max_slots=3, kv_pool=pool).serve(
        [ServeRequest(prompt=p, max_new=4)
         for p in _prefix_prompts(lstm, 5, seed=37)])
    assert all(isinstance(r, ServeResult) for r in res)
    assert list(teng._step_cache) == keys


def test_scheduler_pool_and_spec_drain(lstm):
    """kv_pool= and spec= together: outcomes (composite head names), the
    pool and the spec stats equal the reference's, and the tokens equal a
    drain without either."""
    reqs = [dict(prompt=p, max_new=5)
            for p in _prefix_prompts(lstm, 5, seed=41)]
    teng, ((got, snap, pool), (want, jsnap, _)) = _sched_both(
        lstm, reqs, lambda P: P(64, 4), max_len=32, max_slots=(2, 2),
        policy=(StaticPolicy("exact"), JStatic("exact")),
        spec=(SpecPolicy(drafts=("screened",), draft_len=3, min_ratio=1.0),
              JSpecPolicy(drafts=("screened",), draft_len=3,
                          min_ratio=1.0)))
    assert got == want
    assert {o[1] for o in got} == {"exact+spec[screened]"}
    assert snap["pool"] == jsnap["pool"] and snap["spec"] == jsnap["spec"]
    assert pool.pages_in_use == 0
    plain = ContinuousScheduler(teng, policy=StaticPolicy("exact"),
                                max_slots=2).serve(
        [ServeRequest(**r) for r in reqs])
    assert [o[2] for o in got] == [r.tokens.tolist() for r in plain]
