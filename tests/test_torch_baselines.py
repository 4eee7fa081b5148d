"""The port's §4.1 baselines, their adapter heads, the low-rank perplexity
and the engine's host-side heads against the JAX package's, on the CPU.

  * ``core/baselines.py``: each method's ids equal the reference's
    (``assert_array_equal``; LSH with the same seed), and its cost model;
  * ``heads/adapters.py``: ``topk`` / ``topk_logprobs`` / ``next`` of every
    adapter head (``svd``, ``shortlist``, ``greedy-mips``, ``lsh-mips``,
    ``pca-mips``, ``screened-cpu``) against the reference head's (ids
    exactly, floats within rtol = atol = 1e-5), ``describe()``, and
    sampling from the caller's ``torch.Generator``;
  * ``core/lowrank.py``: ``hybrid_logits`` and ``perplexity`` within 1e-5
    of the reference's where its scatter is well defined, and exact logits
    inside every candidate set where it is not (ROADMAP.md Queue 3);
  * the engine: full-rank ``svd`` greedy tokens equal ``exact``'s and the
    JAX engine's, beam search runs, ``compiled_step_counts`` is 0 for a
    host head, ``serve_batch`` and a ``DecodeStream`` through host heads,
    and sampled host-head decoding is reproducible from its seed;
  * the router: Zipfian traffic over the port's own ``adaptive``,
    ``screened`` and ``exact`` heads routes as the reference routes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import heads as jheads
from repro.core import baselines as jbase
from repro.core import lowrank as jlow
from repro.core.screening import ScreenParams as JScreen
from repro.core.screening import candidates_to_padded
from repro_torch import heads
from repro_torch.core import baselines as tbase
from repro_torch.core import lowrank as tlow
from repro_torch.interop import screen_from_numpy

from torch_serving_fixtures import lstm_fx, prompts

L, D, N = 300, 24, 40
TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF = -1e30


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    W = rng.standard_normal((L, D)).astype(np.float32)
    b = rng.standard_normal(L).astype(np.float32) * 0.1
    H = rng.standard_normal((N, D)).astype(np.float32)
    freq = rng.permutation(L)
    return W, b, H, freq


# -- the methods ---------------------------------------------------------------

BUILDS = {
    "svd": lambda m, W, b, f: m.SVDSoftmax.build(W, b, rho=8, n_top=60),
    "svd-full": lambda m, W, b, f: m.SVDSoftmax.build(W, b, rho=D, n_top=L),
    "shortlist": lambda m, W, b, f: m.AdaptiveShortlist.build(
        W, b, f, n_head=30, n_tails=4),
    "shortlist-head-only": lambda m, W, b, f: m.AdaptiveShortlist.build(
        W, b, f, n_head=L, n_tails=4),
    "greedy-mips": lambda m, W, b, f: m.GreedyMIPS.build(W, b, budget=64),
    "lsh-mips": lambda m, W, b, f: m.LSHMIPS.build(W, b, bands=6, bits=4,
                                                   seed=3),
    "pca-mips": lambda m, W, b, f: m.PCAMIPS.build(W, b, depth=3),
}


@pytest.mark.parametrize("name", list(BUILDS))
def test_baseline_ids_equal_the_reference(setup, name):
    W, b, H, freq = setup
    want = BUILDS[name](jbase, W, b, freq)
    got = BUILDS[name](tbase, W, b, freq)
    for k in (1, 5, 40):
        np.testing.assert_array_equal(got.topk(H, k), want.topk(H, k))
    cost = "flops_per_query"
    if name.startswith("shortlist"):
        assert got.flops_per_query(0.3) == want.flops_per_query(0.3)
    elif hasattr(want, cost):
        assert getattr(got, cost) == getattr(want, cost)


def test_augmented_database_equals_the_reference(setup):
    W = setup[0]
    (ga, gm), (wa, wm) = tbase._augment_db(W), jbase._augment_db(W)
    np.testing.assert_array_equal(ga, wa)
    assert gm == wm


# -- the adapter heads -----------------------------------------------------------

@pytest.fixture(scope="module")
def screen(setup):
    """A word-level screen over 6 clusters, one of them empty."""
    W, _, _, _ = setup
    rng = np.random.default_rng(5)
    v = rng.standard_normal((6, D)).astype(np.float32)
    mask = rng.random((6, L)) < 0.3
    mask[5] = False
    idx, lens = candidates_to_padded(mask, L)
    return (JScreen(v=jnp.asarray(v), cand_idx=jnp.asarray(idx),
                    cand_len=jnp.asarray(lens), vocab_size=L),
            screen_from_numpy(v, idx, lens, L))


HEADS = {"svd": dict(rho=8, n_top=80), "shortlist": dict(n_head=30),
         "greedy-mips": dict(budget=64), "lsh-mips": dict(bands=6, bits=4),
         "pca-mips": dict(depth=3), "screened-cpu": {}}


def _head_pair(setup, screen, name):
    W, b, _, freq = setup
    kw = dict(HEADS[name], freq_order=freq)
    return (jheads.get(name, W=W, b=b, screen=screen[0], **kw),
            heads.get(name, device="cpu", W=W, b=b, screen=screen[1], **kw))


@pytest.mark.parametrize("name", list(HEADS))
def test_adapter_head_matches_the_reference(setup, screen, name):
    jh, th = _head_pair(setup, screen, name)
    H = setup[2]
    h = torch.from_numpy(H)
    for k in (1, 5):
        for fn in ("topk", "topk_logprobs"):
            ji, jv = getattr(jh, fn)(H, k)
            ti, tv = getattr(th, fn)(h, k)
            assert ti.dtype == torch.int32 and ti.device == h.device
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(th.next(h).numpy(), np.asarray(jh.next(H)))
    want, got = jh.describe(), th.describe()
    assert got.keys() == want.keys() and not got["is_jittable"]
    for key, w in want.items():                  # bytes_per_query is NaN
        assert got[key] == w or (w != w and got[key] != got[key]), key


@pytest.mark.parametrize("name", ["svd", "lsh-mips"])
def test_adapter_sample_draws_from_the_generator(setup, screen, name):
    """``sample`` draws (B, pool) Gumbel noise from the caller's generator:
    the same seed gives the same tokens, and given noise G the head picks
    the argmax of its pool's scores + G."""
    _, th = _head_pair(setup, screen, name)
    h = torch.from_numpy(setup[2])
    draw = [th.sample(h, 0.8, generator=torch.Generator().manual_seed(4))
            for _ in range(2)]
    assert torch.equal(*draw) and draw[0].dtype == torch.int32
    shape = th.noise_shape(N, 0.8)
    assert shape == (N, 64) and th.noise_shape(N, 0.0) is None
    g = torch.from_numpy(np.random.default_rng(6).gumbel(size=shape)
                         .astype(np.float32))
    ids, scores = th._topk(h, 64)
    pick = np.argmax(np.where(scores <= NEG_INF / 2, NEG_INF, scores / 0.8)
                     + g.numpy(), axis=-1)
    want = np.take_along_axis(ids, pick[:, None], 1)[:, 0]
    np.testing.assert_array_equal(th.sample(h, 0.8, gumbel=g).numpy(),
                                  np.where(want < L, want, 0))


# -- low-rank perplexity -----------------------------------------------------------

def _lowrank_case(block, L_, item0):
    """W, b, U, Vt, H, targets and a screen pair over 4 clusters. The
    reference's scatter writes word 0 from every padded slot (and, with
    blocks, word L − 1 from every padded row of the last block), so its
    logits are defined where item 0 is in no cluster and L is a multiple of
    the block (``item0=False``)."""
    rng = np.random.default_rng(block + L_)
    W = rng.standard_normal((L_, D)).astype(np.float32)
    b = (rng.standard_normal(L_) * 0.1).astype(np.float32)
    H = rng.standard_normal((32, D)).astype(np.float32)
    t = rng.integers(0, L_, 32)
    v = rng.standard_normal((4, D)).astype(np.float32)
    n_items = -(-L_ // block)
    mask = rng.random((4, n_items)) < 0.5
    mask[:, 0] = item0
    idx, lens = candidates_to_padded(mask, L_, block=block)
    U, Vt = tlow.build_lowrank(W, 6)
    js = JScreen(v=jnp.asarray(v), cand_idx=jnp.asarray(idx),
                 cand_len=jnp.asarray(lens), vocab_size=L_, block=block)
    return (W, b, U, Vt, H, t, mask, js,
            screen_from_numpy(v, idx, lens, L_, block))


@pytest.mark.parametrize("block", [1, 128])
def test_hybrid_logits_and_perplexity_match_the_reference(block):
    W, b, U, Vt, H, t, _, js, ts = _lowrank_case(block, 256, item0=False)
    jU, jVt = jlow.build_lowrank(W, 6)
    np.testing.assert_array_equal(U, jU)
    np.testing.assert_array_equal(Vt, jVt)
    Wt, bt = torch.from_numpy(W), torch.from_numpy(b)
    got = tlow.hybrid_logits(Wt, bt, torch.from_numpy(U),
                             torch.from_numpy(Vt), ts, torch.from_numpy(H))
    want = jlow.hybrid_logits(jnp.asarray(W), jnp.asarray(b), jnp.asarray(U),
                              jnp.asarray(Vt), js, jnp.asarray(H))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tlow.perplexity(Wt, bt, U, Vt, ts, H, t, batch=12),
        jlow.perplexity(W, b, U, Vt, js, H, t, batch=12), **TOL)
    np.testing.assert_allclose(tlow.exact_perplexity(Wt, bt, H, t, batch=12),
                               jlow.exact_perplexity(W, b, H, t, batch=12),
                               **TOL)


@pytest.mark.parametrize("block,L_", [(1, 300), (128, 300), (128, 256)])
def test_hybrid_logits_exact_inside_every_candidate_set(block, L_):
    """Item 0 in every cluster and (L = 300) a padded last block, where the
    reference's scatter overwrites exact logits: the port gives the exact
    logit at every candidate word and the rank-ρ one elsewhere."""
    W, b, U, Vt, H, _, mask, _, ts = _lowrank_case(block, L_, item0=True)
    got = tlow.hybrid_logits(torch.from_numpy(W), torch.from_numpy(b),
                             torch.from_numpy(U), torch.from_numpy(Vt), ts,
                             torch.from_numpy(H)).numpy()
    cluster = np.argmax(H @ ts.v.numpy().T, axis=1)
    words = np.repeat(mask, block, axis=1)[:, :L_][cluster]
    want = np.where(words, H @ W.T + b, (H @ Vt.T) @ U.T + b)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# -- host heads in the engine ----------------------------------------------------

@pytest.fixture(scope="module")
def lstm():
    return lstm_fx()


def _engines(lstm):
    from repro.serving.engine import DecodeEngine as JEngine
    from repro_torch.serving import DecodeEngine
    d, V = lstm["tmodel"].cfg.d_model, lstm["vocab"]
    kw = dict(rho=d, n_top=V, budget=96)
    return (JEngine(lstm["jmodel"], lstm["jparams"], max_len=32,
                    head_kwargs=kw),
            DecodeEngine(lstm["tmodel"], lstm["tparams"],
                         screen=lstm["tscreen"], max_len=32, device="cpu",
                         head_kwargs=kw))


def test_numpy_baseline_head_decodes(lstm):
    """Twin of the reference's ``test_numpy_baseline_head_decodes``: a
    full-rank SVD head decodes the exact head's tokens (and the JAX
    engine's), beam search runs, and the host head's steps hold no
    graph."""
    jeng, eng = _engines(lstm)
    p = prompts(lstm, 2, 5, 1)
    exact = eng.generate(p, 6, head="exact")
    svd = eng.generate(p, 6, head="svd")
    np.testing.assert_array_equal(exact.tokens, svd.tokens)
    np.testing.assert_array_equal(svd.tokens,
                                  jeng.generate(p, 6, head="svd").tokens)
    bm = eng.beam_search(p[0], beam=3, max_new=4, head="svd")
    assert bm.tokens.shape == (1, 4)
    jb = jeng.beam_search(p[0], beam=3, max_new=4, head="svd")
    np.testing.assert_array_equal(bm.tokens, jb.tokens)
    counts = eng.compiled_step_counts()
    assert counts[("svd", "greedy")] == counts[("svd", "decode")] == 0
    assert eng.host_model_graphs() == 0               # no graph on the CPU


@pytest.mark.parametrize("name", ["greedy-mips", "screened-cpu"])
def test_host_heads_serve_batch_and_stream(lstm, name):
    """A host head through ``serve_batch`` equals solo ``generate`` and the
    JAX engine's tokens, and a width-3 ``DecodeStream`` with 4 joins through
    it gives each request's solo tokens."""
    from repro.serving.request import ServeRequest as JRequest
    from repro_torch.serving import ServeRequest, StaticPolicy
    jeng, eng = _engines(lstm)
    p = prompts(lstm, 4, 6, 2)
    reqs = [ServeRequest(prompt=x, max_new=5) for x in p]
    solo = [eng.generate(x[None], 5, head=name).tokens[0] for x in p]
    if name == "greedy-mips":
        from repro.serving.router import StaticPolicy as JStatic
        jres = jeng.serve_batch([JRequest(prompt=x, max_new=5) for x in p],
                                policy=JStatic(name))
        for r, s in zip(jres, solo):
            np.testing.assert_array_equal(r.tokens, s)
    for r, s in zip(eng.serve_batch(reqs, policy=StaticPolicy(name)), solo):
        assert r.head == name
        np.testing.assert_array_equal(r.tokens, s)
    stream = eng.open_stream(name, width=3)
    out = {}
    queue = list(enumerate(reqs))
    while queue or stream.n_active:
        while queue and stream.free_slots:
            i, r = queue.pop(0)
            stream.join(r, tag=i)
        for tag, _, toks in stream.step():
            out[tag] = toks
    for i, s in enumerate(solo):
        np.testing.assert_array_equal(out[i], s)
    assert eng.compiled_step_counts()[(name, "greedy")] == 0


def test_sampled_host_head_is_reproducible(lstm):
    """A sampled host head draws its noise from the engine's generator: the
    same seed gives the same tokens, equal to the head's own draws."""
    from repro_torch.testing import head_sampled_generate
    _, eng = _engines(lstm)
    p = prompts(lstm, 3, 5, 3)
    a = eng.generate(p, 6, head="svd", temperature=0.9, seed=7)
    b = eng.generate(p, 6, head="svd", temperature=0.9, seed=7)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(
        a.tokens, head_sampled_generate(eng, p, 6, "svd", 0.9, seed=7))


# -- the router on the port's own heads -------------------------------------------

def test_cost_aware_routes_zipfian_traffic_to_adaptive():
    """Twin of the reference's
    ``test_cost_aware_routes_zipfian_traffic_to_adaptive``, the catalog built
    from the port's own heads: on a Zipfian unigram the adaptive head
    undercuts a dense 0.5-density screen, a floor above its 0.98 falls back
    to the screened head, and a floor of 1 to exact — as the reference's
    policy routes on the reference's catalog."""
    from repro.serving.request import ServeRequest as JRequest
    from repro.serving.router import CostAwarePolicy as JPolicy
    from repro_torch.serving import CostAwarePolicy, ServeRequest
    rng = np.random.default_rng(13)
    Lz, d, r = 600, 32, 4
    W = rng.standard_normal((Lz, d)).astype(np.float32)
    b = np.zeros((Lz,), np.float32)
    v = rng.standard_normal((r, d)).astype(np.float32)
    idx, lens = candidates_to_padded(rng.random((r, Lz)) < 0.5, Lz)
    counts = rng.permutation(1e6 / np.arange(1, Lz + 1) ** 1.5)
    ctx = dict(W=W, b=b, counts=counts, shortlist=64, n_tails=2)
    tscreen = screen_from_numpy(v, idx, lens, Lz)
    jscreen = JScreen(v=jnp.asarray(v), cand_idx=jnp.asarray(idx),
                      cand_len=jnp.asarray(lens), vocab_size=Lz)
    names = ["adaptive", "screened", "exact"]
    cat = {n: heads.get(n, device="cpu", screen=tscreen, **ctx).describe()
           for n in names}
    jcat = {n: jheads.get(n, screen=jscreen, **ctx).describe() for n in names}
    assert cat["adaptive"]["flops_per_query"] < cat["screened"][
        "flops_per_query"]
    prompt = np.arange(6)
    for floor, want in ((0.0, "adaptive"), (0.99, "screened"),
                        (1.0, "exact")):
        got = CostAwarePolicy(names).route(
            ServeRequest(prompt=prompt, max_new=4, accuracy_floor=floor), cat)
        ref = JPolicy(names).route(
            JRequest(prompt=prompt, max_new=4, accuracy_floor=floor), jcat)
        assert got == ref == want, floor


def test_launcher_accepts_the_new_heads(capsys):
    """``python -m repro_torch.launch.serve --head svd`` serves (exit 0) and
    an unknown head still exits 2."""
    from repro_torch.launch import serve
    base = ["--arch", "ptb-small-lstm", "--reduced", "--device", "cpu",
            "--train-steps", "4", "--requests", "2", "--max-new", "3"]
    assert serve.main(base + ["--head", "svd"]) == 0
    assert "svd decode" in capsys.readouterr().out
    assert serve.main(base + ["--head", "no-such-head"]) == 2
