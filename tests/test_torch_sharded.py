"""The port's vocab-sharded heads (``exact-sharded``, ``screened-sharded``
with ``local="torch"`` and ``local="cuda"``, ``adaptive-sharded``) against
the JAX package's on the same seeded numpy inputs, on the CPU, at 1, 2 and
8 shards over the reference tests' 203-word vocabulary (neither 2 nor 8
divides it; at 8 shards of a 128-row multiple, shards 2–7 own nothing).

  * heads: ids bit-identical to the JAX twin's; values within 1e-6 of the
    port's unsharded twin (the reference tests' tolerance for that
    comparison) and within 1e-5 of the JAX twin (two frameworks' float32
    sums); log-probs within 1e-5; draws equal the JAX twin's given the same
    Gumbel noise. ``exact-sharded`` at k = 120 over 8 shards is held to
    ``exact``, the case whose reference test fails on its 1e-6 values;
  * ``local="cuda"`` runs the fused kernel's plain version per shard: ids
    equal ``exact`` / ``screened-cuda`` and ``local="torch"``;
  * placement: slab shapes, shards past the vocabulary all sentinel, the
    resident bytes equal to the reference's;
  * ``simulate_sharded_topk`` equals one global top-k (hypothesis);
  * serving on reduced nmt-deen-lstm: ``generate`` (greedy, sampled),
    ``beam_search``, ``serve_batch``, the plain, paged and speculative
    streams and the scheduler through the sharded heads give the unsharded
    twins' tokens (and the JAX engine's); a sampled spec stream with a
    sharded verify is refused, and so is a head with a shard on another
    device than the engine's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import heads as jheads
from repro.core.screening import ScreenParams as JScreen
from repro.core.screening import candidates_to_padded
from repro.heads.sharded import simulate_sharded_topk as j_simulate
from repro.serving import DecodeEngine as JEngine
from repro_torch import heads
from repro_torch.heads import ScreenBlockError
from repro_torch.heads.base import NEG_INF
from repro_torch.heads.sharded import simulate_sharded_topk
from repro_torch.interop import screen_from_numpy
from repro_torch.kernels.ref import topk_desc
from repro_torch.serving import (ContinuousScheduler, DecodeEngine, PagePool,
                                 ServeRequest, TierPolicy)
from torch_serving_fixtures import lstm_fx, prompts

LS, D, R, N = 203, 32, 4, 16
V_BLK = 128
SHARDS = [1, 2, 8]
VALS = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's name for the port's shard-local backends
J_LOCAL = {"torch": "jnp", "cuda": "pallas"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The heads run many small operations a shard: on one thread each, so
    that workers sharing the machine's cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _screen_pair(v, mask, block=1):
    idx, lens = candidates_to_padded(mask, LS, block=block)
    return (JScreen(v=jnp.asarray(v), cand_idx=jnp.asarray(idx),
                    cand_len=jnp.asarray(lens), vocab_size=LS, block=block),
            screen_from_numpy(v, idx, lens, LS, block))


@pytest.fixture(scope="module")
def fx():
    """The fixtures of the reference's sharded tests: a word screen of
    random candidate sets (``test_heads_parity.py``, seed 7) and a full
    block-coverage screen (``test_kernels_fused.py``, seed 23)."""
    rng = np.random.default_rng(7)
    W = rng.standard_normal((LS, D)).astype(np.float32)
    b = (rng.standard_normal(LS) * 0.1).astype(np.float32)
    h = rng.standard_normal((N, D)).astype(np.float32)
    v = rng.standard_normal((R, D)).astype(np.float32)
    mask = rng.random((R, LS)) < 0.5
    mask[:, 0] = True
    jw, tw = _screen_pair(v, mask)
    rng = np.random.default_rng(23)
    Wf = rng.standard_normal((LS, D)).astype(np.float32)
    bf = (rng.standard_normal(LS) * 0.1).astype(np.float32)
    hf = rng.standard_normal((N, D)).astype(np.float32)
    vf = rng.standard_normal((R, D)).astype(np.float32)
    jb, tb = _screen_pair(vf, np.ones((R, -(-LS // V_BLK)), bool), V_BLK)
    return dict(W=W, b=b, h=h, jword=jw, tword=tw, Wf=Wf, bf=bf, hf=hf,
                jblock=jb, tblock=tb)


def _jax_ok(n):
    """The JAX side needs n host devices (tests/conftest.py makes 8)."""
    return jax.device_count() >= n


def _thead(name, W, b, **kw):
    return heads.get(name, device="cpu", W=W, b=b, **kw)


def _jhead(name, W, b, **kw):
    if "local" in kw:
        kw = dict(kw, local=J_LOCAL[kw["local"]])
    return jheads.get(name, W=jnp.asarray(W), b=jnp.asarray(b), **kw)


def _same(got, want, tol):
    (ti, tv), (wi, wv) = got, want
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
    np.testing.assert_allclose(tv.numpy(), np.asarray(wv), **tol)


# -- the heads against their JAX twins -----------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("k", [5, 40, 120])
def test_exact_sharded_bit_identical(fx, n_shards, k):
    W, b, h = fx["W"], fx["b"], fx["h"]
    ht = torch.from_numpy(h)
    head = _thead("exact-sharded", W, b, n_shards=n_shards)
    exact = _thead("exact", W, b)
    assert head.n_shards == n_shards == head.describe()["n_shards"]
    jh = None
    if _jax_ok(n_shards):
        twin = "exact" if (k, n_shards) == (120, 8) else "exact-sharded"
        jh = _jhead(twin, W, b, n_shards=n_shards)
    for query in ("topk", "topk_logprobs"):
        got = getattr(head, query)(ht, k)
        _same(got, getattr(exact, query)(ht, k),
              VALS if query == "topk" else TOL)
        if jh is not None:
            _same(got, getattr(jh, query)(jnp.asarray(h), k), TOL)
    np.testing.assert_array_equal(head.next(ht).numpy(),
                                  exact.next(ht).numpy())
    g = torch.from_numpy(np.random.default_rng(k).gumbel(size=(N, LS))
                         .astype(np.float32))
    for t, p in ((0.0, 1.0), (0.8, 1.0), (1.0, 0.9)):
        np.testing.assert_array_equal(
            head.sample(ht, t, p, gumbel=g).numpy(),
            exact.sample(ht, t, p, gumbel=g).numpy())
    assert head.noise_shape(N, 1.0) == exact.noise_shape(N, 1.0)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("k", [5, 40])
def test_screened_sharded_matches_screened(fx, n_shards, k):
    """Word screen of random candidate sets, k above every shard's
    candidate count at 8 shards: ids equal ``screened``'s and the JAX
    twin's; values and log-probs 1e-5 (the reference test's)."""
    W, b, h = fx["W"], fx["b"], fx["h"]
    ht = torch.from_numpy(h)
    head = _thead("screened-sharded", W, b, screen=fx["tword"],
                  n_shards=n_shards)
    plain = _thead("screened", W, b, screen=fx["tword"])
    jh = (_jhead("screened-sharded", W, b, screen=fx["jword"],
                 n_shards=n_shards) if _jax_ok(n_shards) else None)
    for query in ("topk", "topk_logprobs"):
        got = getattr(head, query)(ht, k)
        _same(got, getattr(plain, query)(ht, k), TOL)
        if jh is not None:
            _same(got, getattr(jh, query)(jnp.asarray(h), k), TOL)
    cand = fx["tword"].cand_idx.numpy()
    allowed = set(cand[cand < LS].tolist())
    s = head.sample(ht, 1.0, generator=torch.Generator().manual_seed(1))
    assert set(s.tolist()) <= allowed
    np.testing.assert_array_equal(head.sample(ht, 0.0).numpy(),
                                  plain.topk(ht, 1)[0][:, 0].numpy())


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("k", [5, 40, 120])
def test_adaptive_sharded_matches_adaptive(fx, n_shards, k):
    """shortlist 50 over 3 tails of 51 words (neither a V_BLK nor a shard
    multiple), counts None (the weight-norm order), k = 120 past the short
    list (every row descends): ids equal ``adaptive``'s and the JAX
    twin's, log-probs never NaN. At k = 120 the JAX twin (whose
    interpret-mode kernel compiles for ~7 s a shard count) is held at 8
    shards only; at 1 and 2 shards ``adaptive`` stands for it
    (``test_torch_adaptive.py`` holds it to the JAX ``adaptive`` at
    k = 120)."""
    W, b, h = fx["W"], fx["b"], fx["h"]
    ht = torch.from_numpy(h)
    kw = dict(shortlist=50, n_tails=3)
    head = _thead("adaptive-sharded", W, b, n_shards=n_shards, **kw)
    plain = _thead("adaptive", W, b, **kw)
    jh = (_jhead("adaptive-sharded", W, b, n_shards=n_shards, **kw)
          if _jax_ok(n_shards) and (k < 120 or n_shards == 8) else None)
    for query in ("topk", "topk_logprobs"):
        got = getattr(head, query)(ht, k)
        _same(got, getattr(plain, query)(ht, k),
              VALS if query == "topk" else TOL)
        assert not torch.isnan(got[1]).any()
        if jh is not None:
            _same(got, getattr(jh, query)(jnp.asarray(h), k), TOL)
    np.testing.assert_array_equal(head.next(ht).numpy(),
                                  plain.next(ht).numpy())
    np.testing.assert_array_equal(head.sample(ht, 0.0).numpy(),
                                  plain.next(ht).numpy())


@pytest.mark.parametrize("name,screen,kw", [
    ("exact-sharded", None, {}),
    ("screened-sharded", "word", {}),
    ("screened-sharded", "block", {"local": "cuda"}),
    ("adaptive-sharded", None, {"shortlist": 50, "n_tails": 3}),
], ids=["exact", "screened-torch", "screened-cuda", "adaptive"])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_sampled_draw_equals_the_reference_given_its_noise(fx, name, screen,
                                                           kw, n_shards):
    """``sample`` with the reference's ``jax.random.gumbel`` noise of the
    port's ``noise_shape`` draws the JAX twin's ids (temperature and
    nucleus)."""
    if not _jax_ok(n_shards):
        pytest.skip(f"the JAX side needs {n_shards} host devices")
    sfx = "" if screen is None else screen
    W, b, h = ((fx["Wf"], fx["bf"], fx["hf"]) if sfx == "block" else
               (fx["W"], fx["b"], fx["h"]))
    th = _thead(name, W, b, n_shards=n_shards, **kw, **(
        {} if screen is None else {"screen": fx["t" + sfx]}))
    jh = _jhead(name, W, b, n_shards=n_shards, **kw, **(
        {} if screen is None else {"screen": fx["j" + sfx]}))
    key = jax.random.key(5)
    for t, p in ((1.0, 1.0), (0.7, 0.9)):
        g = np.asarray(jax.random.gumbel(key, th.noise_shape(N, t),
                                         jnp.float32))
        want = np.asarray(jh.sample(key, jnp.asarray(h), t, p))
        got = th.sample(torch.from_numpy(h), t, p,
                        gumbel=torch.from_numpy(np.array(g)))
        np.testing.assert_array_equal(got.numpy(), want)


# -- local="cuda": the fused kernel once per shard ------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("k", [1, 5, 40])
def test_sharded_fused_local_bit_identical_to_exact(fx, n_shards, k):
    W, b, h = fx["Wf"], fx["bf"], fx["hf"]
    ht = torch.from_numpy(h)
    head = _thead("screened-sharded", W, b, screen=fx["tblock"],
                  n_shards=n_shards, local="cuda")
    assert head.local == "cuda" and head.Ls % V_BLK == 0
    got = head.topk(ht, k)
    _same(got, _thead("exact", W, b).topk(ht, k), TOL)
    if _jax_ok(n_shards):
        jh = _jhead("screened-sharded", W, b, screen=fx["jblock"],
                    n_shards=n_shards, local="cuda")
        _same(got, jh.topk(jnp.asarray(h), k), TOL)
    word = _thead("screened-sharded", W, b, screen=fx["tblock"],
                  n_shards=n_shards)
    assert torch.equal(word.topk(ht, k)[0], got[0])
    assert torch.equal(head.next(ht), got[0][:, 0])


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("k", [5, 40])
def test_sharded_fused_local_matches_screened_cuda(fx, n_shards, k):
    """Ids equal the unsharded ``screened-cuda``'s, log-probs within 1e-5
    (the shards' logZ pieces recombine to the candidate logZ); the draws,
    on the word path, stay in the vocabulary and are greedy at t = 0."""
    W, b, h = fx["Wf"], fx["bf"], fx["hf"]
    ht = torch.from_numpy(h)
    head = _thead("screened-sharded", W, b, screen=fx["tblock"],
                  n_shards=n_shards, local="cuda")
    cuda = _thead("screened-cuda", W, b, screen=fx["tblock"])
    got = head.topk_logprobs(ht, k)
    _same(got, cuda.topk_logprobs(ht, k), TOL)
    if _jax_ok(n_shards):
        jh = _jhead("screened-sharded", W, b, screen=fx["jblock"],
                    n_shards=n_shards, local="cuda")
        _same(got, jh.topk_logprobs(jnp.asarray(h), k), TOL)
    s = head.sample(ht, 1.0, generator=torch.Generator().manual_seed(2))
    assert s.min() >= 0 and s.max() < LS
    assert torch.equal(head.sample(ht, 0.0), cuda.topk(ht, 1)[0][:, 0])


def test_sharded_local_validation(fx):
    """An unknown backend (the reference's names included) and a word
    screen with local="cuda" fail when the head is built."""
    W, b = fx["W"], fx["b"]
    for bad in ("tpu", "jnp", "pallas"):
        with pytest.raises(ValueError, match="'torch' or 'cuda'"):
            _thead("screened-sharded", W, b, screen=fx["tword"], n_shards=1,
                   local=bad)
    with pytest.raises(ScreenBlockError, match="block"):
        _thead("screened-sharded", W, b, screen=fx["tword"], n_shards=1,
               local="cuda")
    with pytest.raises(heads.MissingScreenError):
        _thead("screened-sharded", W, b, n_shards=2)
    with pytest.raises(ValueError, match="n_shards=3"):
        _thead("exact-sharded", W, b, n_shards=3, devices=["cpu"] * 2)


# -- placement --------------------------------------------------------------------

def test_sharded_weights_actually_partitioned(fx):
    """Each shard holds its own 1/n of the padded rows and its own tables;
    rows past the vocabulary are zero with a NEG_INF bias, and shards past
    it hold only sentinels (blocks 2..7 of an 8-way, 128-row split)."""
    W, b = fx["Wf"], fx["bf"]
    ex = _thead("exact-sharded", W, b, n_shards=8)
    assert [tuple(w.shape) for w, _ in ex.slabs] == [(26, D)] * 8
    w7, b7 = ex.slabs[-1]
    assert torch.equal(w7[LS - 7 * 26:], torch.zeros((8 * 26 - LS, D)))
    assert bool((b7[LS - 7 * 26:] == NEG_INF).all())
    assert torch.equal(torch.cat([w for w, _ in ex.slabs])[:LS],
                       torch.from_numpy(W))
    assert len({w.data_ptr() for w, _ in ex.slabs}) == 8
    assert not hasattr(ex, "W")                     # only the slabs stay
    sc = _thead("screened-sharded", W, b, screen=fx["tblock"], n_shards=8,
                local="cuda")
    nbs = sc.Ls // V_BLK
    assert (sc.Ls, nbs) == (V_BLK, 1)
    for s, (w, bb, words, blocks) in enumerate(sc.slabs):
        assert tuple(w.shape) == (V_BLK, D) and tuple(bb.shape) == (V_BLK,)
        assert tuple(blocks.shape) == (R, 1)
        empty = s >= 2
        assert bool((blocks == nbs).all()) == empty
        assert bool((words == sc.Ls).all()) == empty
    assert bool((sc.slabs[0][3] == 0).all())       # shard 0 owns block 0
    ad = _thead("adaptive-sharded", W, b, shortlist=50, n_tails=3,
                n_shards=8)
    assert [tuple(w.shape) for w in ad._Wt] == [(1, V_BLK, D)] * 8
    assert bool((torch.stack(ad._btab[3:]) == 1).all())


@pytest.mark.parametrize("name,kw", [
    ("exact-sharded", {}),
    ("screened-sharded", {"screen": "word"}),
    ("screened-sharded", {"screen": "block", "local": "cuda"}),
    ("adaptive-sharded", {"shortlist": 50, "n_tails": 3}),
], ids=["exact", "screened-torch", "screened-cuda", "adaptive"])
def test_describe_and_resident_bytes_match_the_reference(fx, name, kw):
    """``memory_bytes`` counts the slabs (no copy of the unsharded W), the
    same total as the reference's at 8 shards; ``describe`` carries the
    shard count and the per-shard cost model."""
    if not _jax_ok(8):
        pytest.skip("the JAX side needs 8 host devices")
    sfx = kw.get("screen")
    W, b = (fx["Wf"], fx["bf"]) if sfx == "block" else (fx["W"], fx["b"])
    tkw = dict(kw, **({} if sfx is None else {"screen": fx["t" + sfx]}))
    jkw = dict(kw, **({} if sfx is None else {"screen": fx["j" + sfx]}))
    th = _thead(name, W, b, n_shards=8, **tkw)
    jh = _jhead(name, W, b, n_shards=8, **jkw)
    td, jd = th.describe(), jh.describe()
    assert td.keys() == jd.keys()
    for key in ("memory_bytes", "n_shards", "supports_sampling",
                "supports_dist", "is_jittable"):
        assert td[key] == jd[key], key
    for key in ("flops_per_query", "bytes_per_query"):
        assert td[key] == pytest.approx(jd[key]), key


# -- the merge ------------------------------------------------------------------

@given(st.integers(2, 64), st.integers(1, 9), st.integers(1, 16),
       st.integers(0, 10_000), st.booleans())
@settings(max_examples=10, deadline=None)
def test_sharded_topk_merge_equals_global(L, n_shards, k, seed, ties):
    """Per-shard top-min(k, L_shard), offsets, shard-major gather, re-top-k
    == one global top-k (ids with the lowest-index tie-break, and values)
    for any logits, shard count and k ≤ L, and == the reference's
    ``simulate_sharded_topk``; ``ties`` draws small integers."""
    k = min(k, L)
    rng = np.random.default_rng(seed)
    logits = (rng.integers(-3, 4, (3, L)) if ties else
              rng.standard_normal((3, L))).astype(np.float32)
    ids, vals = simulate_sharded_topk(torch.from_numpy(logits), n_shards, k)
    gvals, gids = topk_desc(torch.from_numpy(logits), k)
    assert torch.equal(ids, gids.to(torch.int32)) and torch.equal(vals, gvals)
    jids, jvals = j_simulate(jnp.asarray(logits), n_shards, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


# -- serving --------------------------------------------------------------------

@pytest.fixture(scope="module")
def lstm():
    return lstm_fx()


def _engine(fx, max_len=40, **kw):
    return DecodeEngine(fx["tmodel"], fx["tparams"], screen=fx["tscreen"],
                        max_len=max_len, device="cpu", **kw)


AD_KW = dict(shortlist=128, n_tails=3)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_heads_decode_end_to_end(lstm, n_shards):
    """Greedy, sampled and beam decode through the engine's cached steps:
    each sharded head's tokens equal its unsharded twin's (``exact``,
    ``screened`` for the word path, ``screened-cuda`` for local="cuda",
    ``adaptive``); sampled ``exact-sharded`` == sampled ``exact`` (the same
    noise), the other draws stay in the vocabulary and, for the screened
    head, in the routed candidate union; at 2 shards the greedy tokens also
    equal the JAX engine's."""
    eng = _engine(lstm, head_kwargs=dict(n_shards=n_shards, **AD_KW))
    p = prompts(lstm, 2, 6, seed=13)
    cuda = heads.get("screened-sharded", device="cpu", W=eng.W, b=eng.b,
                     screen=eng.screen, n_shards=n_shards, local="cuda")
    pairs = [("exact-sharded", "exact"), ("screened-sharded", "screened"),
             (cuda, "screened-cuda"), ("adaptive-sharded", "adaptive")]
    greedy = {}
    for sharded, twin in pairs:
        got = eng.generate(p, 8, head=sharded)
        greedy[twin] = eng.generate(p, 8, head=twin).tokens
        np.testing.assert_array_equal(got.tokens, greedy[twin])
        bm = eng.beam_search(p[0], 3, 5, head=sharded)
        ref = eng.beam_search(p[0], 3, 5, head=twin)
        np.testing.assert_array_equal(bm.tokens, ref.tokens)
        np.testing.assert_allclose(bm.scores, ref.scores, atol=1e-4)
    s = eng.generate(p, 6, head="exact-sharded", temperature=0.9, seed=5)
    np.testing.assert_array_equal(
        s.tokens, eng.generate(p, 6, head="exact", temperature=0.9,
                               seed=5).tokens)
    cand = lstm["word_mask"]
    for head in ("screened-sharded", cuda, "adaptive-sharded"):
        t0 = eng.generate(p, 6, head=head, temperature=0.0)
        s = eng.generate(p, 6, head=head, temperature=1.0, seed=5)
        assert 0 <= s.tokens.min() and s.tokens.max() < lstm["vocab"]
        if head != "adaptive-sharded":
            assert cand[:, s.tokens.reshape(-1)].any(axis=0).all()
            np.testing.assert_array_equal(t0.tokens,
                                          greedy["screened"][:, :6])
    for name in ("exact-sharded", "screened-sharded", "adaptive-sharded"):
        hd = eng.resolve_head(name)
        assert hd.n_shards == n_shards and hd.mesh is None
        assert (hd.step_key(), "greedy") in eng._step_cache
    assert all(n == 0 for n in eng.compiled_step_counts().values())
    if n_shards == 2:
        jeng = JEngine(lstm["jmodel"], lstm["jparams"], screen=lstm["jscreen"],
                       max_len=40, head_kwargs=dict(n_shards=n_shards))
        for name, twin in pairs[:2]:
            np.testing.assert_array_equal(
                jeng.generate(p, 8, head=name).tokens, greedy[twin])


def test_paged_stream_parity_sharded_head(lstm):
    """Paged streams (page 4) through an 8-shard exact head equal solo
    generate on it and on ``exact``."""
    eng = _engine(lstm, max_len=24, head_kwargs=dict(n_shards=8))
    rng = np.random.default_rng(41)
    tmpl = rng.integers(0, lstm["vocab"], size=10)
    reqs = [ServeRequest(prompt=np.concatenate(
        [tmpl, rng.integers(0, lstm["vocab"], size=3)]).astype(np.int32),
        max_new=4) for _ in range(4)]
    pool = PagePool(64, 4)
    stream = eng.open_paged_stream(pool, head="exact-sharded", width=2)
    got, pending = {}, list(enumerate(reqs))
    while pending or stream.n_active or stream._finished:
        while pending and stream.free_slots:
            i, r = pending.pop(0)
            stream.join(r, tag=i)
        for tag, _, toks in stream.step():
            got[tag] = toks
    for i, r in enumerate(reqs):
        for head in ("exact-sharded", "exact"):
            ref = eng.generate(r.prompt[None], r.max_new, head=head).tokens[0]
            np.testing.assert_array_equal(got[i], ref)
    assert pool.radix.hit_rate > 0


TIERS = ("realtime", "standard", "batch")


def _mixed(fx, n, sampled_idx=()):
    ps = prompts(fx, n, 6, seed=21)
    return [ServeRequest(prompt=ps[i], max_new=4 + (i % 3),
                         latency_tier=TIERS[i % 3],
                         temperature=0.9 if i in sampled_idx else None,
                         top_p=0.95 if i in sampled_idx else 1.0, seed=7)
            for i in range(n)]


POLICY = {"realtime": "screened", "standard": "screened-sharded",
          "batch": "exact"}


def test_mixed_batch_parity_with_sharded(lstm):
    """8 requests over three heads, one an 8-shard screened head, and one
    sampled request: every result equals a solo ``generate``; one cached
    step per (head, kind), none added by a second batch."""
    eng = _engine(lstm, max_len=30, head_kwargs=dict(n_shards=8))
    policy = TierPolicy(POLICY, default="exact")
    reqs = _mixed(lstm, 8, sampled_idx=(6,))
    eng.serve_batch(reqs, policy=policy)
    warm = eng._cache_size()
    results = eng.serve_batch(reqs, policy=policy)
    assert {r.head for r in results} == set(POLICY.values())
    assert eng.resolve_head("screened-sharded").n_shards == 8
    assert warm == eng._cache_size() == 4
    for req, res in zip(reqs, results):
        kw = ({} if req.temperature is None else
              dict(temperature=req.temperature, top_p=req.top_p,
                   seed=req.seed))
        solo = eng.generate(req.prompt[None], req.max_new, head=res.head,
                            **kw)
        np.testing.assert_array_equal(solo.tokens[0], res.tokens)


def test_scheduler_drain_parity_with_sharded_head(lstm):
    """The scheduler with an 8-shard screened head in its mix: results
    equal ``serve_batch``'s, a second drain adds no cached step and no
    graph."""
    eng = _engine(lstm, max_len=30, head_kwargs=dict(n_shards=8))
    policy = TierPolicy(POLICY, default="exact")
    reqs = _mixed(lstm, 6)
    ref = eng.serve_batch(reqs, policy=policy)
    out = ContinuousScheduler(eng, policy=policy, max_slots=2).serve(reqs)
    assert {r.head for r in out} == set(POLICY.values())
    for r, e in zip(out, ref):
        assert r.head == e.head
        np.testing.assert_array_equal(r.tokens, e.tokens)
    counts, size = eng.compiled_step_counts(), eng._cache_size()
    ContinuousScheduler(eng, policy=policy, max_slots=2).serve(reqs)
    assert eng.compiled_step_counts() == counts
    assert eng._cache_size() == size == 3


def _spec_run(stream, reqs):
    done = {}
    for i, r in enumerate(reqs):
        stream.join(r, tag=i)
    for _ in range(200):
        for tag, _, toks in stream.step():
            done[tag] = toks
        if stream.idle:
            return done
    raise AssertionError("stream never drained")


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_verify_greedy_parity(lstm, n_shards):
    """Greedy speculative decode with an exact-SHARDED verify: tokens equal
    plain ``exact`` generate; one cached verify step."""
    eng = _engine(lstm)
    p = prompts(lstm, 3, 6, seed=42)
    base = eng.generate(p, 8, head="exact")
    sharded = heads.get("exact-sharded", device="cpu", W=eng.W, b=eng.b,
                        n_shards=n_shards)
    stream = eng.open_spec_stream("screened", sharded, width=4, draft_len=4)
    done = _spec_run(stream, [ServeRequest(prompt=q, max_new=8) for q in p])
    for i in range(3):
        np.testing.assert_array_equal(done[i], base.tokens[i])
    assert stream.rounds > 0
    assert eng.compiled_step_counts()[("exact-sharded", "spec-verify")] == 0
    assert sum(k[1] == "spec-verify" for k in eng._step_cache) == 1


def test_sharded_verify_refuses_sampled(lstm):
    eng = _engine(lstm)
    sharded = heads.get("exact-sharded", device="cpu", W=eng.W, b=eng.b,
                        n_shards=2)
    with pytest.raises(ValueError, match="unsharded"):
        eng.open_spec_stream("screened", sharded, temperature=0.8)


def test_engine_refuses_shards_on_another_device(lstm):
    """A head whose shards span a device other than the engine's is
    refused where the engine resolves it, by name or as an instance."""
    eng = _engine(lstm, head_kwargs=dict(devices=["cpu", "meta"]))
    with pytest.raises(ValueError, match="one device"):
        eng.resolve_head("exact-sharded")
    far = heads.ExactShardedHead(eng.W, eng.b, devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="meta"):
        eng.generate(prompts(lstm, 1, 4, seed=0), 2, head=far)
    near = heads.ExactShardedHead(eng.W, eng.b, devices=["cpu"] * 3)
    assert eng.generate(prompts(lstm, 1, 4, seed=0), 2, head=near).steps == 2
