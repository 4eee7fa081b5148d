"""The port's Algorithm 1 (fitting the screen) and its evaluation against
the JAX package's on the same seeded numpy inputs. Where the reference draws
randomness the port is handed the same draw: the Gumbel noise (``p_soft``
and the straight-through gradient within 1e-6, the one-hot equal), the
k-means seed row (centres within 1e-5, assignments equal) and the v-step's
batch (new v, loss and L̄ within 1e-6 relative). The knapsack c-step is bit
for bit. A whole ``fit_l2s`` drawing from each side's own generator is held
to P@5 > 0.9 and to the reference's coverage within 0.02; handed the
reference's draws, it ends at the reference's screen. Also
``collect_contexts``, the metrics, and screens carried between the two
packages both ways."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import heads as jheads
from repro.configs import L2SConfig as JL2SConfig
from repro.configs import get_config as j_get_config
from repro.core import evaluate as jeval
from repro.core import screening as jscreen
from repro.core.gumbel import gumbel_softmax_st as j_gumbel_st
from repro.core.gumbel import sample_gumbel as j_sample_gumbel
from repro.core.kmeans import spherical_kmeans as j_kmeans
from repro.core.knapsack import candidate_stats as j_stats
from repro.core.knapsack import greedy_knapsack as j_knapsack
from repro.core.train_l2s import _hits_matrix as j_hits
from repro.core.train_l2s import _vstep_batch as j_vstep
from repro.core.train_l2s import collect_contexts as j_collect
from repro.core.train_l2s import fit_l2s as j_fit
from repro.core.train_l2s import kmeans_only_screen as j_kmeans_only
from repro.models import build_model
from repro_torch import heads
from repro_torch.configs import L2SConfig, get_config
from repro_torch.core import (assign_clusters, candidate_stats,
                              collect_contexts, fit_l2s, greedy_knapsack,
                              gumbel_softmax_st, kmeans_assign,
                              precision_at_k, spherical_kmeans)
from repro_torch.core import evaluate
from repro_torch.core.gumbel import sample_gumbel
from repro_torch.core.screening import screened_topk
from repro_torch.core.train_l2s import (_hits_matrix, _vstep_batch,
                                        kmeans_only_screen)
from repro_torch.interop import (params_from_numpy, screen_from_numpy,
                                 screen_to_numpy)
from repro_torch.models import Model


def _coverage(screen_v, mask, H, y, block=1):
    """Fraction of the true top-k inside the routed candidate set."""
    assign = np.argmax(H @ np.asarray(screen_v).T, axis=-1)
    items = y // block if block > 1 else y
    return mask[assign][np.arange(len(H))[:, None], items].mean()


@pytest.fixture(scope="module")
def structured():
    """``tests/test_core_l2s.py``'s fixture: 8 latent modes, each with its
    own top-word set."""
    rng = np.random.default_rng(0)
    L, d, N = 200, 16, 4000
    modes = rng.standard_normal((8, d)).astype(np.float32) * 3
    W = rng.standard_normal((L, d)).astype(np.float32)
    mode_of = rng.integers(0, 8, N)
    H = (modes[mode_of] + 0.3 * rng.standard_normal((N, d))).astype(np.float32)
    y = np.argsort(-(H @ W.T), axis=1)[:, :5].astype(np.int32)
    return dict(L=L, W=W, H=H, y=y)


def _round_v(v, mask):
    """``eval_fn`` of a fit: each round's v after its v-steps."""
    return {"v": np.array(v)}


@pytest.fixture(scope="module")
def fits(structured):
    """Both packages' fit on the structured fixture, same config."""
    kw = dict(num_clusters=8, budget=30, outer_iters=2, sgd_steps=150)
    s = structured
    return dict(ours=fit_l2s(s["H"], s["y"], s["L"], L2SConfig(**kw),
                             device="cpu"),
                ref=j_fit(s["H"], s["y"], s["L"], JL2SConfig(**kw),
                          eval_fn=_round_v), kw=kw)


# -- the relaxation and the initialisation -----------------------------------------

def test_gumbel_st_matches_given_the_reference_noise():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((64, 10)).astype(np.float32) * 2
    key = jax.random.key(5)
    noise = np.array(j_sample_gumbel(key, logits.shape))
    weights = rng.standard_normal(10).astype(np.float32)
    for temp in (1.0, 0.5):
        jbar, jsoft = j_gumbel_st(key, jnp.asarray(logits), temp)
        tl = torch.as_tensor(logits).requires_grad_(True)
        tbar, tsoft = gumbel_softmax_st(tl, temp, noise=torch.as_tensor(noise))
        np.testing.assert_allclose(tsoft.detach().numpy(), np.asarray(jsoft),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            tbar.detach().numpy().argmax(-1), np.asarray(jbar).argmax(-1))
        np.testing.assert_allclose(tbar.detach().numpy(), np.asarray(jbar),
                                   rtol=0, atol=1e-6)
        (g,) = torch.autograd.grad((tbar * torch.as_tensor(weights)).sum(), tl)
        jg = jax.grad(lambda lg: jnp.sum(
            j_gumbel_st(key, lg, temp)[0] * weights))(jnp.asarray(logits))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-6)


def test_sample_gumbel_is_standard_gumbel():
    g = sample_gumbel((200_000,), torch.Generator().manual_seed(0))
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.01      # Euler–Mascheroni
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03


def test_spherical_kmeans_matches_given_the_seed_row():
    rng = np.random.default_rng(0)
    centers = np.eye(8)[:3] * 10
    X = np.concatenate([centers[i] + 0.05 * rng.standard_normal((50, 8))
                        for i in range(3)]).astype(np.float32)
    key = jax.random.key(4)
    first = int(jax.random.randint(key, (), 0, X.shape[0]))
    want = np.asarray(j_kmeans(key, jnp.asarray(X), 3))
    got = spherical_kmeans(torch.as_tensor(X), 3, first=first)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assign = kmeans_assign(got, torch.as_tensor(X)).numpy()
    np.testing.assert_array_equal(
        assign, np.asarray(jnp.argmax(jnp.asarray(X) @ want.T, axis=-1)))
    assert len(np.unique(assign)) == 3
    # drawn from a generator: the same clusters, up to their order
    drawn = spherical_kmeans(torch.as_tensor(X), 3,
                             torch.Generator().manual_seed(0))
    a2 = kmeans_assign(drawn, torch.as_tensor(X)).numpy()
    for i in range(3):
        assert len(np.unique(a2[i * 50:(i + 1) * 50])) == 1


# -- the c-step and the v-step --------------------------------------------------------

@pytest.mark.parametrize("block", [1, 2, 128])
def test_knapsack_c_step_bit_identical(block):
    rng = np.random.default_rng(block)
    N, k, r, L = 3000, 5, 12, 900
    assign = rng.integers(0, r, N)
    assign[assign == 3] = 4                     # an empty cluster
    topk = rng.integers(0, L, (N, k)).astype(np.int32)
    counts, sizes = candidate_stats(assign, topk, r, L, block)
    jc, js = j_stats(assign, topk, r, L, block)
    np.testing.assert_array_equal(counts, jc)
    np.testing.assert_array_equal(sizes, js)
    for budget in (block * 2.0, 40.0 * block, 1e9):
        got = greedy_knapsack(counts, sizes, N, budget, 3e-4, L, block)
        want = j_knapsack(jc, js, N, budget, 3e-4, L, block)
        np.testing.assert_array_equal(got, want)


def test_vstep_batch_matches_given_the_same_draws():
    rng = np.random.default_rng(2)
    B, r, d, L, k = 64, 12, 16, 300, 5
    v = rng.standard_normal((r, d)).astype(np.float32)
    h = rng.standard_normal((B, d)).astype(np.float32)
    mask = rng.random((r, L)) < 0.2
    y = rng.integers(0, L, (B, k)).astype(np.int32)
    cand_words = mask.sum(1).astype(np.float32)
    hits = np.array(j_hits(jnp.asarray(mask, jnp.float32), jnp.asarray(y), 1))
    np.testing.assert_array_equal(
        _hits_matrix(torch.as_tensor(mask, dtype=torch.float32),
                     torch.as_tensor(y), 1).numpy(), hits)
    key = jax.random.key(9)
    noise = np.array(j_sample_gumbel(key, (B, r)))
    for lbar0, budget in ((0.0, 30.0), (80.0, 30.0)):   # penalty off / on
        jv, jl, jlb = j_vstep(jnp.asarray(v), key, jnp.asarray(h),
                              jnp.asarray(hits), jnp.asarray(cand_words),
                              jnp.float32(lbar0), budget, 3e-4, 10.0, 1.0, k,
                              1, 0.05)
        tv, tl, tlb = _vstep_batch(
            torch.as_tensor(v), torch.as_tensor(h), torch.as_tensor(hits),
            torch.as_tensor(cand_words), torch.tensor(lbar0), budget, 3e-4,
            10.0, 1.0, k, 0.05, noise=torch.as_tensor(noise))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        np.testing.assert_allclose(float(tlb), float(jlb), rtol=1e-6)
        assert not np.array_equal(tv.numpy(), v)


@pytest.mark.parametrize("side", ["ours", "ref"])
def test_fit_l2s_precision_on_structured_contexts(structured, fits, side):
    """P@5 > 0.9 against the exact top-5 (each side's own draws)."""
    s, st = structured, fits[side]
    v, idx, lens, vocab, block = (
        screen_to_numpy(st.screen) if side == "ours" else
        (np.asarray(st.screen.v), np.asarray(st.screen.cand_idx),
         np.asarray(st.screen.cand_len), st.screen.vocab_size,
         st.screen.block))
    screen = screen_from_numpy(v, idx, lens, vocab, block)
    pred = evaluate.screened_predictions(torch.as_tensor(s["W"]),
                                         torch.zeros(s["L"]), screen, s["H"],
                                         5)
    assert precision_at_k(pred, s["y"]) > 0.9


def test_fit_l2s_coverage_matches_the_reference(structured, fits):
    s = structured
    ours, ref = fits["ours"], fits["ref"]
    cov = ours.history[-1]["coverage_best"]
    assert abs(cov - ref.history[-1]["coverage_best"]) <= 0.02
    # the returned screen gives back the coverage it reports
    np.testing.assert_allclose(
        _coverage(ours.screen.v.numpy(), ours.mask, s["H"], s["y"]), cov,
        rtol=0, atol=1e-12)
    assert [set(h) for h in ours.history[:-1]] == [
        {"round", "loss", "lbar", "coverage", "cstep_s", "vstep_s"}] * 2
    km = kmeans_only_screen(s["H"], s["y"], s["L"], L2SConfig(**fits["kw"]),
                            device="cpu")
    jkm = j_kmeans_only(s["H"], s["y"], s["L"], JL2SConfig(**fits["kw"]))
    assert abs(_coverage(km.screen.v.numpy(), km.mask, s["H"], s["y"]) -
               _coverage(jkm.screen.v, jkm.mask, s["H"], s["y"])) <= 0.02


def _reference_draws(cfg, N):
    """The draws the reference's ``fit_l2s`` makes from ``cfg.seed``: the
    k-means seed row, then per v-step its batch rows and Gumbel noise."""
    key = jax.random.key(cfg.seed)
    key, sk = jax.random.split(key)
    first = int(jax.random.randint(sk, (), 0, min(N, 50_000)))
    steps = []
    for _ in range(cfg.outer_iters * cfg.sgd_steps):
        key, kb, kg = jax.random.split(key, 3)
        steps.append((np.array(jax.random.randint(kb, (cfg.batch_size,), 0, N)),
                      np.array(j_sample_gumbel(kg, (cfg.batch_size,
                                                    cfg.num_clusters)))))
    return first, steps


def test_fit_l2s_follows_the_reference_given_its_draws(structured, fits):
    """Handed the reference's draws, the port's fit follows the reference's:
    the same masks and coverages, each round's v (after its v-steps) within
    1e-5 of its scale, L̄ and loss within 1e-5 relative."""
    s, ref = structured, fits["ref"]
    cfg = L2SConfig(**fits["kw"])
    first, steps = _reference_draws(cfg, len(s["H"]))
    got = fit_l2s(s["H"], s["y"], s["L"], cfg, device="cpu", first=first,
                  batches=steps, eval_fn=_round_v)
    np.testing.assert_array_equal(got.mask, ref.mask)
    for a, b in zip(got.history, ref.history):
        assert a.get("coverage", a.get("coverage_best")) == \
            b.get("coverage", b.get("coverage_best"))
        if "v" in a:
            np.testing.assert_allclose(a["lbar"], b["lbar"], rtol=1e-5)
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
            np.testing.assert_allclose(a["v"], b["v"], rtol=0,
                                       atol=1e-5 * np.abs(b["v"]).max())
    want = np.asarray(ref.screen.v)
    np.testing.assert_allclose(got.screen.v.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the reference's ablation seeds k-means from the unsplit key
    km_first = int(jax.random.randint(jax.random.key(cfg.seed), (), 0,
                                      min(len(s["H"]), 50_000)))
    km = kmeans_only_screen(s["H"], s["y"], s["L"], cfg, device="cpu",
                            first=km_first)
    jkm = j_kmeans_only(s["H"], s["y"], s["L"], JL2SConfig(**fits["kw"]))
    np.testing.assert_allclose(km.screen.v.numpy(), np.asarray(jkm.screen.v),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(km.mask, jkm.mask)


def test_fit_l2s_block_screen_routes_to_tiles(structured):
    """vocab_block = 128: the screen's items are tiles of the vocab."""
    s = structured
    cfg = L2SConfig(num_clusters=4, budget=200, outer_iters=1, sgd_steps=20,
                    vocab_block=128)
    st = fit_l2s(s["H"], s["y"], s["L"], cfg, device="cpu")
    assert st.screen.block == 128 and st.mask.shape == (4, 2)
    assert st.screen.cand_idx.dtype == torch.int32
    assert int(st.screen.cand_idx.max()) <= 2          # n_items sentinel
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit_l2s(s["H"], s["y"], s["L"], cfg)


# -- harvesting and evaluation ----------------------------------------------------------

def test_collect_contexts_matches():
    jcfg = j_get_config("ptb-small-lstm").reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.key(1), dtype=jnp.float32)
    jparams["embed"]["lm_head"] = jparams["embed"]["lm_head"] * 50.0
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    model = Model(get_config("ptb-small-lstm").reduced())
    rng = np.random.default_rng(3)
    toks = [rng.integers(0, jcfg.vocab_size, (3, 10)).astype(np.int32)
            for _ in range(3)]
    H, y = collect_contexts(model, tparams, [torch.as_tensor(t) for t in toks],
                            max_vectors=70, k=5)
    jH, jy = j_collect(jmodel, jparams, [jnp.asarray(t) for t in toks],
                       max_vectors=70, k=5)
    assert H.shape == (70, jcfg.d_model) and y.shape == (70, 5)
    assert y.dtype == jy.dtype == np.int32
    np.testing.assert_allclose(H, jH, rtol=0, atol=1e-5)
    W, b = (np.asarray(a) for a in jmodel.softmax_weights(jparams))
    logits = np.sort(jH @ W.T + b, axis=-1)[:, ::-1]
    gaps = logits[:, :5] - logits[:, 1:6]
    differ = np.nonzero((y != jy).any(-1))[0]
    assert all(gaps[i].min() < 1e-5 for i in differ), differ
    assert len(differ) <= 2


def _exact_data(rng, L=300, d=16, N=400):
    """Values on a grid of 0.5: every logit is exact in float32 in both
    frameworks, and exact ties occur (broken by the lowest id on both)."""
    W = (rng.integers(-2, 3, (L, d)) * 0.5).astype(np.float32)
    b = (rng.integers(-2, 3, L) * 0.5).astype(np.float32)
    H = (rng.integers(-2, 3, (N, d)) * 0.5).astype(np.float32)
    return W, b, H


@pytest.mark.parametrize("block", [1, 128])
def test_metrics_and_per_query_screen_equal(block):
    rng = np.random.default_rng(block)
    W, b, H = _exact_data(rng)
    L, r = W.shape[0], 6
    n_items = -(-L // block)
    mask = rng.random((r, n_items)) < (0.5 if block > 1 else 0.1)
    mask[2] = False                                  # an empty cluster
    v = (rng.integers(-2, 3, (r, W.shape[1])) * 0.5).astype(np.float32)
    idx, lens = jscreen.candidates_to_padded(mask, L, block)
    jsp = jscreen.ScreenParams(v=jnp.asarray(v), cand_idx=jnp.asarray(idx),
                               cand_len=jnp.asarray(lens), vocab_size=L,
                               block=block)
    tsp = screen_from_numpy(v, idx, lens, L, block)
    tW, tb = torch.as_tensor(W), torch.as_tensor(b)
    jW, jb = jnp.asarray(W), jnp.asarray(b)
    ex = evaluate.exact_topk(tW, tb, H, 5, batch=128)
    np.testing.assert_array_equal(ex, jeval.exact_topk(jW, jb, H, 5,
                                                       batch=128))
    pred = evaluate.screened_predictions(tW, tb, tsp, H, 5, batch=128)
    np.testing.assert_array_equal(
        pred, jeval.screened_predictions(jW, jb, jsp, H, 5, batch=128))
    assert (evaluate.precision_at_k(pred, ex)
            == jeval.precision_at_k(pred, ex))
    assert (evaluate.avg_candidate_size(tsp, H)
            == jeval.avg_candidate_size(jsp, H))
    assert (evaluate.speedup_model(25_000, 500, 100, 312.5)
            == jeval.speedup_model(25_000, 500, 100, 312.5))
    ours, ref = evaluate.PerQueryScreen(tW, tb, tsp), jeval.PerQueryScreen(
        jW, jb, jsp)
    for h in H[:40]:
        np.testing.assert_array_equal(ours.topk(h, 5), ref.topk(h, 5))
    np.testing.assert_array_equal(
        evaluate.full_softmax_topk_numpy(W, b, H[0], 5),
        jeval.full_softmax_topk_numpy(W, b, H[0], 5))


def test_screens_carry_between_the_packages_both_ways(structured, fits):
    """A JAX-fitted screen routes and screens identically in the port; a
    port-fitted one does in the JAX ``screened`` head."""
    s = structured
    W, b = s["W"], np.zeros(s["L"], np.float32)
    for side in ("ref", "ours"):
        st = fits[side]
        if side == "ref":
            arrays = (np.asarray(st.screen.v), np.asarray(st.screen.cand_idx),
                      np.asarray(st.screen.cand_len), st.screen.vocab_size,
                      st.screen.block)
        else:
            arrays = screen_to_numpy(st.screen)
        v, idx, lens, vocab, block = arrays
        jsp = jscreen.ScreenParams(v=jnp.asarray(v), cand_idx=jnp.asarray(idx),
                                   cand_len=jnp.asarray(lens),
                                   vocab_size=vocab, block=block)
        tsp = screen_from_numpy(*arrays)
        back = screen_to_numpy(tsp)
        for a, c in zip(back, arrays):
            np.testing.assert_array_equal(a, c)
        H = s["H"][:500]
        np.testing.assert_array_equal(
            assign_clusters(tsp.v, torch.as_tensor(H)).numpy(),
            np.asarray(jscreen.assign_clusters(jsp.v, jnp.asarray(H))))
        jh = jheads.get("screened", W=jnp.asarray(W), b=jnp.asarray(b),
                        screen=jsp)
        th = heads.get("screened", W=W, b=b, screen=tsp, device="cpu")
        jids, jvals = jh.topk(jnp.asarray(H), 5)
        tids, tvals = th.topk(torch.as_tensor(H), 5)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals),
                                   rtol=1e-5, atol=1e-5)
        ids, _ = screened_topk(torch.as_tensor(W), torch.as_tensor(b), tsp,
                               torch.as_tensor(H), 5)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
