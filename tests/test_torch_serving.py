"""The port's step cache, head metadata, requests, routing policies and
``serve_batch`` against the JAX package's, on the CPU.

Model: ``nmt-deen-lstm`` reduced (d = 128, V = 512), weights initialised in
JAX and carried across with ``params_from_numpy``, a 128-word block screen
(the CUDA head's) and a 1-word screen (which the kernel heads refuse).

  * step cache: its keys, the LRU of 32 (a hit refreshes recency), a
    transient head instance over the same tensors hitting the hot entry,
    and no graph on the CPU (``compiled_step_counts`` all 0);
  * metadata: ``describe()`` has the reference's keys, and
    ``flops_per_query``, ``bytes_per_query`` and ``memory_bytes`` equal the
    reference head's (``screened-cuda`` against ``screened-pallas``);
  * router: the reference's router cases (``tests/test_serving_router.py``)
    routed by both packages on the same catalogs give the same names;
  * ``serve_batch``: greedy results equal solo ``generate`` and the JAX
    engine's ``serve_batch`` on the same requests and policy (every step of
    the reference's decode decided by a top-2 gap above 1e-4), and
    ``head_catalog`` omits the heads the reference omits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import heads as jheads
from repro.configs import get_config as j_get_config
from repro.core.screening import ScreenParams as JScreen
from repro.core.screening import candidates_to_padded
from repro.models.model import Model as JModel
from repro.serving import router as jrouter
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.request import ServeRequest as JRequest
from repro_torch.configs import get_config
from repro_torch.heads import ScreenBlockError, ScreenedCudaHead
from repro_torch.interop import params_from_numpy, screen_from_numpy
from repro_torch.models import Model
from repro_torch.serving import (CostAwarePolicy, DecodeEngine, ServeRequest,
                                 StaticPolicy, route_requests)
from repro_torch.serving import router as trouter
from repro_torch.testing import (eager_beam_search, eager_generate,
                                 head_sampled_generate)

V_BLK = 128
GAP = 1e-4
# the port's name for the reference's kernel head
TWIN = {"screened-cuda": "screened-pallas"}


@pytest.fixture(scope="module")
def fx():
    jcfg = j_get_config("nmt-deen-lstm").reduced()
    vocab, d = jcfg.vocab_size, jcfg.d_model
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(11))
    jparams["embed"]["lm_head"] = jparams["embed"]["lm_head"] * 100.0
    rng = np.random.default_rng(11)
    r, n_blk = 4, vocab // V_BLK
    mask = np.zeros((r, n_blk), bool)
    mask[0, [0, 3]] = True
    mask[1, 1:3] = True
    mask[2, :] = True
    mask[3, [1, 3]] = True
    idx, lens = candidates_to_padded(mask, vocab, block=V_BLK)
    v = (rng.standard_normal((r, d)) * 3).astype(np.float32)
    words = rng.random((r, vocab)) < 0.5
    widx, wlens = candidates_to_padded(words, vocab)
    return dict(
        jmodel=jmodel, jparams=jparams,
        tmodel=Model(get_config("nmt-deen-lstm").reduced()),
        tparams=params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams)),
        v=v, word_mask=np.repeat(mask, V_BLK, axis=1)[:, :vocab],
        jscreen=JScreen(v=jnp.asarray(v), cand_idx=jnp.asarray(idx),
                        cand_len=jnp.asarray(lens), vocab_size=vocab,
                        block=V_BLK),
        tscreen=screen_from_numpy(v, idx, lens, vocab, V_BLK),
        jwords=JScreen(v=jnp.asarray(v), cand_idx=jnp.asarray(widx),
                       cand_len=jnp.asarray(wlens), vocab_size=vocab),
        twords=screen_from_numpy(v, widx, wlens, vocab),
        prompts=rng.integers(0, vocab, (8, 7)).astype(np.int32))


def _engine(fx, screen="tscreen", **kw):
    return DecodeEngine(fx["tmodel"], fx["tparams"], screen=fx.get(screen),
                        max_len=32, device="cpu", **kw)


def _top2_gap(x):
    s = np.sort(np.asarray(x, np.float64), axis=-1)
    return s[..., -1] - s[..., -2]


def _assert_decided(fx, prompt, tokens, screened):
    """Every step of the reference's greedy decode of ``prompt`` is decided
    by a top-2 gap above GAP (within the routed candidates, and between
    cluster scores, on the screened path)."""
    seq = np.concatenate([prompt, tokens[:-1]])[None]
    h, _ = fx["jmodel"].forward(fx["jparams"], {"tokens": jnp.asarray(seq)})
    h = np.asarray(h)[0, len(prompt) - 1:]
    logits = np.asarray(fx["jmodel"].logits(fx["jparams"], jnp.asarray(h)))
    if screened:
        scores = h @ fx["v"].T
        assert _top2_gap(scores).min() > GAP
        logits = np.where(fx["word_mask"][scores.argmax(-1)], logits, -np.inf)
    assert _top2_gap(logits).min() > GAP


# -- step cache -----------------------------------------------------------------

def test_step_cache_keys_and_no_graph_on_the_cpu(fx):
    eng = _engine(fx)
    hd = eng.resolve_head("screened-cuda")
    p = fx["prompts"][:2]
    greedy = eng.generate(p, 4, head="screened-cuda")
    eng.generate(p, 4, head="screened-cuda", temperature=0.7, top_p=0.9,
                 seed=3)
    beam = eng.beam_search(p[0], 3, 4, head="screened-cuda")
    sk = hd.step_key()
    assert list(eng._step_cache) == [(sk, "greedy"), (sk, "sample", 0.7, 0.9),
                                     (sk, "decode")]
    assert eng.compiled_step_counts() == {("screened-cuda", "greedy"): 0,
                                          ("screened-cuda", "sample"): 0,
                                          ("screened-cuda", "decode"): 0}
    # the step bodies run eagerly give the same tokens and beam
    np.testing.assert_array_equal(
        eager_generate(eng, p, 4, head="screened-cuda").tokens, greedy.tokens)
    eb = eager_beam_search(eng, p[0], 3, 4, head="screened-cuda")
    np.testing.assert_array_equal(eb.tokens, beam.tokens)
    np.testing.assert_array_equal(eb.scores, beam.scores)
    assert eng._cache_size() == 3


def test_step_key_is_stable_over_the_same_tensors(fx):
    eng = _engine(fx)
    hot = eng.resolve_head("screened-cuda")
    transient = ScreenedCudaHead(eng.W, eng.b, eng.screen).prepare()
    assert transient.step_key() == hot.step_key()
    assert transient._Wb is not hot._Wb
    unfused = ScreenedCudaHead(eng.W, eng.b, eng.screen, fused=False)
    assert unfused.step_key() != hot.step_key()
    assert eng.resolve_head("exact").step_key() != hot.step_key()
    eng.generate(fx["prompts"][:1], 2, head="screened-cuda")
    for _ in range(3):
        eng.generate(fx["prompts"][:1], 2,
                     head=ScreenedCudaHead(eng.W, eng.b,
                                           eng.screen).prepare())
        assert eng._cache_size() == 1


def test_step_cache_is_an_lru_of_32(fx):
    eng = _engine(fx)
    hd = eng.resolve_head("exact")
    sk = hd.step_key()
    eng._greedy_step(hd)                                 # A, oldest inserted
    for i in range(31):                                  # full at 32
        eng._sample_step(hd, 1.0 + i, 1.0)
    assert eng._cache_size() == 32
    eng._greedy_step(hd)                                 # hit A: most recent
    eng._sample_step(hd, 0.5, 1.0)                       # evicts T = 1.0
    assert eng._cache_size() == 32
    assert (sk, "greedy") in eng._step_cache
    assert (sk, "sample", 1.0, 1.0) not in eng._step_cache
    assert (sk, "sample", 2.0, 1.0) in eng._step_cache
    assert next(iter(eng._step_cache)) == (sk, "sample", 2.0, 1.0)


def test_slabs_live_for_one_call_on_the_cpu(fx):
    """A slab lives while a graph holds it; the CPU has no graph, so every
    width's slab is gone when its call returns."""
    eng = _engine(fx)
    for B in (1, 2, 3):
        eng.generate(fx["prompts"][:B], 3)
        eng.generate(fx["prompts"][:B], 3, temperature=0.7, seed=1)
        assert len(eng._slabs) == 0
    eng.beam_search(fx["prompts"][0], 4, 3)
    assert len(eng._slabs) == 0


@pytest.mark.parametrize("top_p", [1.0, 0.8])
@pytest.mark.parametrize("tname,kw", [
    ("exact", {}), ("screened", {}),
    ("screened-cuda", {"fused": True}), ("screened-cuda", {"fused": False}),
], ids=["exact", "screened", "cuda-fused", "cuda-unfused"])
def test_sampled_generate_equals_the_heads_own_draw(fx, tname, kw, top_p):
    """The engine draws the noise of its sampled steps itself, in
    ``head.noise_shape``; its tokens equal those the head's own
    ``sample(h, generator=...)`` draws from the same seed."""
    eng = _engine(fx, head_kwargs=kw)
    p = fx["prompts"][:3]
    got = eng.generate(p, 6, head=tname, temperature=0.7, top_p=top_p,
                       seed=9)
    want = head_sampled_generate(eng, p, 6, tname, 0.7, top_p, seed=9)
    np.testing.assert_array_equal(got.tokens, want)


# -- head metadata ----------------------------------------------------------------

@pytest.mark.parametrize("tname,kw", [
    ("exact", {}), ("screened", {}),
    ("screened-cuda", {"fused": True}), ("screened-cuda", {"fused": False}),
], ids=["exact", "screened", "cuda-fused", "cuda-unfused"])
def test_describe_matches_the_reference_head(fx, tname, kw):
    W, b = fx["jmodel"].softmax_weights(fx["jparams"])
    jh = jheads.get(TWIN.get(tname, tname), W=W, b=b, screen=fx["jscreen"],
                    **kw)
    th = _engine(fx, head_kwargs=kw).resolve_head(tname)
    jd, td = jh.describe(), th.describe()
    assert set(td) == set(jd)
    assert td["device_kind"] == "torch" and td["is_jittable"]
    assert td["n_shards"] is None and td["supports_sampling"]
    for key in ("flops_per_query", "bytes_per_query", "memory_bytes"):
        assert td[key] == jd[key], key
    if tname == "screened-cuda":
        assert th.packed_nbytes == jh.packed_nbytes


def test_head_catalog_omits_what_the_reference_omits(fx):
    names = ["exact", "screened", "screened-cuda"]
    for tscreen, jscreen in (("twords", "jwords"), (None, None)):
        jeng = JEngine(fx["jmodel"], fx["jparams"], screen=fx.get(jscreen),
                       max_len=32)
        want = set(jeng.head_catalog([TWIN.get(n, n) for n in names]))
        got = set(_engine(fx, screen=tscreen).head_catalog(names))
        assert {TWIN.get(n, n) for n in got} == want
    assert set(_engine(fx, screen="twords").head_catalog(names)) == \
        {"exact", "screened"}
    with pytest.raises(ScreenBlockError, match="block"):
        _engine(fx, screen="twords").resolve_head("screened-cuda")
    with pytest.raises(KeyError):
        _engine(fx).head_catalog(["no-such-head"])


# -- router: the reference's cases through both packages ----------------------------

_CATALOG = {
    "exact": {"flops_per_query": 1e6, "memory_bytes": 4_000_000,
              "n_shards": None, "supports_sampling": True},
    "screened": {"flops_per_query": 5e4, "memory_bytes": 4_400_000,
                 "n_shards": None, "supports_sampling": True},
    "screened-sharded": {"flops_per_query": 2e4, "memory_bytes": 4_400_000,
                         "n_shards": 8, "supports_sampling": True},
    "svd": {"flops_per_query": 3e5, "memory_bytes": 5_000_000,
            "n_shards": None, "supports_sampling": False},
}


def _stub(bytes_):
    return {"flops_per_query": float("nan"), "bytes_per_query": bytes_,
            "memory_bytes": 1, "n_shards": None, "supports_sampling": True}


_STUBS = {"stub-a": 0.99, "stub-b": 0.99}
_ALL = ["screened-sharded", "screened", "svd", "exact"]
# (policy class, args, kwargs, request kwargs, catalog, expected route)
ROUTER_CASES = {
    "static": ("StaticPolicy", ("svd",), {}, {}, "base", "svd"),
    "tier-realtime": ("TierPolicy", ({"realtime": "screened",
                                      "batch": "exact"},), {"default": "svd"},
                      {"latency_tier": "realtime"}, "base", "screened"),
    "tier-batch": ("TierPolicy", ({"realtime": "screened", "batch": "exact"},),
                   {"default": "svd"}, {"latency_tier": "batch"}, "base",
                   "exact"),
    "tier-unknown": ("TierPolicy", ({"realtime": "screened",
                                     "batch": "exact"},), {"default": "svd"},
                     {"latency_tier": "unheard-of"}, "base", "svd"),
    "cost-cheapest": ("CostAwarePolicy", (_ALL,), {}, {}, "base",
                      "screened-sharded"),
    "cost-floor-1": ("CostAwarePolicy", (_ALL,), {}, {"accuracy_floor": 1.0},
                     "base", "exact"),
    "cost-wide-k": ("CostAwarePolicy", (_ALL,), {}, {"k": 64}, "base",
                    "exact"),
    "cost-no-sampling-head": ("CostAwarePolicy", (["svd"],),
                              {"fallback": "exact"}, {}, "base", "svd"),
    "cost-sampled-falls-back": ("CostAwarePolicy", (["svd"],),
                                {"fallback": "exact"}, {"temperature": 0.8},
                                "base", "exact"),
    "cost-batch-tier": ("CostAwarePolicy", (_ALL,), {},
                        {"latency_tier": "batch"}, "base", "exact"),
    "memory-tight": ("CostAwarePolicy", (["screened", "screened-sharded"],),
                     {"memory_budget_bytes": 1_000_000}, {}, "base",
                     "screened-sharded"),
    "memory-roomy": ("CostAwarePolicy", (["screened", "screened-sharded"],),
                     {"memory_budget_bytes": 10_000_000}, {}, "base",
                     "screened-sharded"),
    "memory-none-fit": ("CostAwarePolicy", (["screened"],),
                        {"memory_budget_bytes": 1}, {}, "base", "exact"),
    "nan-modeled-wins": ("CostAwarePolicy",
                         (["stub-a", "stub-b", "screened"],),
                         {"accuracy": _STUBS}, {}, "nan", "screened"),
    "nan-candidate-order": ("CostAwarePolicy", (["stub-a", "stub-b"],),
                            {"fallback": "stub-b", "accuracy": _STUBS}, {},
                            "nan", "stub-a"),
    "floor-1-measured": ("CostAwarePolicy", (["screened", "exact"],),
                         {"accuracy": {"screened": 1.0}},
                         {"accuracy_floor": 1.0}, "base", "exact"),
    "floor-1-minus-eps": ("CostAwarePolicy", (["screened", "exact"],),
                          {"accuracy": {"screened": 1.0}},
                          {"accuracy_floor": 1.0 - 1e-17}, "base", "exact"),
    "floor-wide-k": ("CostAwarePolicy", (["screened", "exact"],),
                     {"accuracy": {"screened": 1.0}}, {"k": 64}, "base",
                     "exact"),
    "floor-exact-sharded": ("CostAwarePolicy", (["exact-sharded"],),
                            {"fallback": "exact"}, {"accuracy_floor": 1.0},
                            "sharded", "exact-sharded"),
    "zipf-adaptive": ("CostAwarePolicy", (["adaptive", "screened", "exact"],),
                      {}, {}, "zipf", "adaptive"),
    "zipf-floor-099": ("CostAwarePolicy", (["adaptive", "screened", "exact"],),
                       {}, {"accuracy_floor": 0.99}, "zipf", "screened"),
    "zipf-floor-1": ("CostAwarePolicy", (["adaptive", "screened", "exact"],),
                     {}, {"accuracy_floor": 1.0}, "zipf", "exact"),
}


@pytest.fixture(scope="module")
def catalogs():
    """The reference tests' catalogs; "zipf" is built from the reference's
    own adaptive / screened / exact heads on a Zipfian unigram."""
    from repro.core.screening import ScreenParams
    rng = np.random.default_rng(13)
    Lz, d, r = 600, 32, 4
    W = jnp.asarray(rng.standard_normal((Lz, d)), jnp.float32)
    b = jnp.zeros((Lz,), jnp.float32)
    v = jnp.asarray(rng.standard_normal((r, d)), jnp.float32)
    idx, lens = candidates_to_padded(rng.random((r, Lz)) < 0.5, Lz)
    screen = ScreenParams(v=v, cand_idx=jnp.asarray(idx),
                          cand_len=jnp.asarray(lens), vocab_size=Lz)
    counts = rng.permutation(1e6 / np.arange(1, Lz + 1) ** 1.5)
    zipf = {"screened": jheads.get("screened", W=W, b=b,
                                   screen=screen).describe(),
            "adaptive": jheads.get("adaptive", W=W, b=b, counts=counts,
                                   shortlist=64, n_tails=2).describe(),
            "exact": jheads.get("exact", W=W, b=b).describe()}
    sharded = dict(_CATALOG, **{"exact-sharded": {
        "flops_per_query": 2e5, "memory_bytes": 4_000_000, "n_shards": 8,
        "supports_sampling": True}})
    return {"base": _CATALOG, "nan": dict(_CATALOG, **{
        "stub-a": _stub(9e9), "stub-b": _stub(1.0)}),
        "sharded": sharded, "zipf": zipf}


@pytest.mark.parametrize("case", list(ROUTER_CASES))
def test_router_routes_like_the_reference(catalogs, case):
    cls, args, kw, req_kw, cat, expected = ROUTER_CASES[case]
    prompt = np.random.default_rng(0).integers(0, 50, 6)
    got = getattr(trouter, cls)(*args, **kw).route(
        ServeRequest(prompt=prompt, max_new=4, **req_kw), catalogs[cat])
    want = getattr(jrouter, cls)(*args, **kw).route(
        JRequest(prompt=prompt, max_new=4, **req_kw), catalogs[cat])
    assert got == want == expected


def test_route_requests_and_request_validation_match_the_reference():
    prompt = np.arange(6)
    reqs = [ServeRequest(prompt=prompt, max_new=4, head=h)
            for h in (None, "exact", None)]
    jreqs = [JRequest(prompt=prompt, max_new=4, head=h)
             for h in (None, "exact", None)]
    assert route_requests(reqs, StaticPolicy("screened"), _CATALOG) == \
        jrouter.route_requests(jreqs, jrouter.StaticPolicy("screened"),
                               _CATALOG) == ["screened", "exact", "screened"]
    assert reqs[0].group_key("exact") == jreqs[0].group_key("exact")
    sampled = dict(prompt=prompt, max_new=2, temperature=0.5, top_p=0.9,
                   seed=4)
    assert ServeRequest(**sampled).group_key("x") == \
        JRequest(**sampled).group_key("x")
    ok = dict(prompt=np.arange(4), max_new=2)
    for bad, match in ((dict(k=0), "k must be >= 1"),
                       (dict(max_new=0), "max_new must be >= 1"),
                       (dict(top_p=1.5), r"top_p must be in \(0, 1\]"),
                       (dict(prompt=np.zeros((2, 3))), "1-D")):
        for cls in (ServeRequest, JRequest):
            with pytest.raises(ValueError, match=match):
                cls(**dict(ok, **bad))
    assert trouter.DEFAULT_ACCURACY["screened-cuda"] == \
        jrouter.DEFAULT_ACCURACY["screened-pallas"]


# -- serve_batch ---------------------------------------------------------------------

def _requests(fx, cls):
    p = fx["prompts"]
    spec = [(p[0], 3, {}), (p[1], 4, {"k": 5}), (p[2], 3,
                                                 {"accuracy_floor": 1.0}),
            (p[3][:5], 4, {}), (p[4][:5], 2, {"head": "exact"}),
            (p[5], 5, {"latency_tier": "realtime"})]
    return [cls(prompt=pr, max_new=n, **kw) for pr, n, kw in spec]


def test_serve_batch_matches_solo_generate_and_the_reference(fx):
    eng = _engine(fx)
    pol = CostAwarePolicy(["screened-cuda", "exact"])
    reqs = _requests(fx, ServeRequest)
    got = eng.serve_batch(reqs, policy=pol)
    jeng = JEngine(fx["jmodel"], fx["jparams"], screen=fx["jscreen"],
                   max_len=32)
    want = jeng.serve_batch(_requests(fx, JRequest),
                            policy=jrouter.CostAwarePolicy(
                                ["screened-pallas", "exact"]))
    assert [TWIN.get(r.head, r.head) for r in got] == [r.head for r in want]
    assert [r.head for r in got] == ["screened-cuda", "screened-cuda", "exact",
                                     "screened-cuda", "exact",
                                     "screened-cuda"]
    assert [r.group_size for r in got] == [r.group_size for r in want] == \
        [3, 3, 1, 1, 1, 3]
    for req, r, w in zip(reqs, got, want):
        _assert_decided(fx, req.prompt, np.asarray(w.tokens),
                        screened=r.head != "exact")
        np.testing.assert_array_equal(r.tokens, np.asarray(w.tokens))
        solo = eng.generate(req.prompt[None], req.max_new, head=r.head)
        np.testing.assert_array_equal(solo.tokens[0], r.tokens)
        assert r.request is req and len(r.tokens) == req.max_new
    size = eng._cache_size()
    eng.serve_batch(reqs, policy=pol)
    assert eng._cache_size() == size
    assert not any(eng.compiled_step_counts().values())


def test_serve_batch_default_head_and_sampled_groups(fx):
    eng = _engine(fx, head="screened-cuda")
    assert eng.serve_batch([]) == []
    p = fx["prompts"]
    reqs = [ServeRequest(prompt=p[0], max_new=3),
            ServeRequest(prompt=p[1], max_new=3, temperature=0.8, seed=5),
            ServeRequest(prompt=p[2], max_new=4, temperature=0.8, seed=5),
            ServeRequest(prompt=p[3], max_new=3, temperature=0.8, seed=6)]
    out = eng.serve_batch(reqs)
    assert [r.head for r in out] == ["screened-cuda"] * 4
    assert [r.group_size for r in out] == [1, 2, 2, 1]
    np.testing.assert_array_equal(
        out[0].tokens, eng.generate(p[:1], 3).tokens[0])
    pair = eng.generate(p[1:3], 4, temperature=0.8, seed=5).tokens
    np.testing.assert_array_equal(out[1].tokens, pair[0, :3])
    np.testing.assert_array_equal(out[2].tokens, pair[1])
    np.testing.assert_array_equal(
        out[3].tokens, eng.generate(p[3:4], 3, temperature=0.8,
                                    seed=6).tokens[0])
