"""The port's adaptive (frequency-tiered) head and its per-tier kernel entry
against the JAX package's, on the same seeded numpy inputs, on the CPU:
``_build_tiers`` array for array, ``AdaptiveHead`` fused and unfused (ids
bit-identical, values, logZ and log-probs within rtol = atol = 1e-5; the
reference's fused head runs its Pallas kernel in interpret mode), the
k > short-list forced descent, ``shortlist = L`` against ``exact``, the
−∞-safe ``combine_tier_logz`` / ``_masked_lse``, ``tier_fused_topk``
against ``tier_fused_topk_tpu``, ``merge_shard_topk``, the tiered cost
models and routing metadata, the sampling row, the fused kernel's parts
rule under its shared-memory limit, and greedy / beam decode through the
engine against the JAX engine's. Sizes are the reference tests' (L = 150,
d = 24, B = 8, ``shortlist = 40``, ``n_tails = 3``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import heads as jheads
from repro.heads import adaptive as jadaptive
from repro.heads import base as jbase
from repro.heads.sharded import merge_shard_topk as j_merge
from repro.kernels.ops import pack_head_blocks as j_pack
from repro.kernels.ops import tier_fused_topk_tpu
from repro_torch import heads
from repro_torch.heads import adaptive, base
from repro_torch.heads.sharded import merge_shard_topk
from repro_torch.kernels import ops
from repro_torch.kernels.fused_topk import (SMEM_LIMIT, fused_parts,
                                            merge_smem_bytes)

from torch_serving_fixtures import lstm_fx, prompts

L, D, B = 150, 24, 8
V_BLK = 128
TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF = -1e30


@pytest.fixture(scope="module")
def fx():
    rng = np.random.default_rng(3)
    W = np.asarray(rng.standard_normal((L, D)), np.float32)
    b = np.asarray(rng.standard_normal(L) * 0.1, np.float32)
    h = np.asarray(rng.standard_normal((B, D)), np.float32)
    counts = rng.permutation(1e6 / np.arange(1, L + 1) ** 1.5)
    return W, b, h, counts


def _pair(fx, **kw):
    """(reference head, port head) over the fixture's weights and counts;
    the reference's ``fused`` path runs in interpret mode."""
    W, b, _, counts = fx
    kw = dict(dict(counts=counts, shortlist=40, n_tails=3), **kw)
    return (jheads.get("adaptive", W=W, b=b, **kw),
            heads.get("adaptive", device="cpu", W=W, b=b, **kw))


def _assert_same(jout, tout):
    (ji, jv), (ti, tv) = jout, tout
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv, np.float32), **TOL)


# -- tier layout -------------------------------------------------------------

@pytest.mark.parametrize("counts,shortlist,n_tails", [
    ("zipf", 40, 3), (None, 40, 3), ("zipf", L, 4), ("uniform", 100, 2),
    ("zipf", None, 1), ("zeros", 7, 5)],
    ids=["zipf-40-3", "norms-40-3", "full", "uniform", "none", "zeros"])
def test_build_tiers_equals_the_reference(fx, counts, shortlist, n_tails):
    W, b, _, zipf = fx
    c = {"zipf": zipf, None: None, "uniform": np.ones(L),
         "zeros": np.zeros(L)}[counts]
    want = jadaptive._build_tiers(W, b, c, shortlist, n_tails)
    got = adaptive._build_tiers(W, b, c, shortlist, n_tails)
    assert vars(got).keys() == vars(want).keys()
    for key, w in vars(want).items():
        g = getattr(got, key)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


def test_tier_layout_rejects_bad_inputs(fx):
    W, b, _, _ = fx
    with pytest.raises(ValueError, match="counts"):
        adaptive._build_tiers(W, b, np.ones(L + 1), shortlist=40, n_tails=3)
    with pytest.raises(ValueError, match="n_tails"):
        heads.get("adaptive", device="cpu", W=W, b=b, n_tails=0)


# -- the head against the reference ------------------------------------------

@pytest.fixture(scope="module")
def ref_unfused(fx):
    """The reference's unfused head's (topk, topk_logprobs, next) at each k
    (jnp, no kernel: cheap)."""
    jh, _ = _pair(fx, fused=False)
    h = jnp.asarray(fx[2])
    return {k: (jh.topk(h, k), jh.topk_logprobs(h, k), jh.next(h))
            for k in (5, 40, 120, 140)}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("k", [5, 40, 120])
def test_adaptive_matches_the_reference(fx, ref_unfused, fused, k):
    """Ids bit-identical and values / log-probs within 1e-5 of the
    reference (its fused and unfused ids are bit-identical, its values
    within 2e-5: ``test_fused_matches_unfused``)."""
    _, th = _pair(fx, fused=fused)
    h = torch.from_numpy(fx[2])
    jtop, jlp, jnext = ref_unfused[k]
    _assert_same(jtop, th.topk(h, k))
    _assert_same(jlp, th.topk_logprobs(h, k))
    np.testing.assert_array_equal(th.next(h).numpy(), np.asarray(jnext))


def test_fused_matches_the_reference_fused_kernel(fx):
    """The port's fused head against the reference's Pallas path (interpret
    mode), logZ included (through the log-probs)."""
    jh, th = _pair(fx)
    h = fx[2]
    _assert_same(jh.topk(h, 40), th.topk(torch.from_numpy(h), 40))
    _assert_same(jh.topk_logprobs(h, 5), th.topk_logprobs(torch.from_numpy(h),
                                                          5))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_k_exceeding_shortlist_forces_descent(fx, ref_unfused, fused):
    """k = 140 > nb0·V_BLK = 128: every query descends; valid results are
    the short words and its tail cluster, the rest (NEG_INF, sentinel L) —
    never NaN — as the reference gives them."""
    _, th = _pair(fx, fused=fused)
    h = torch.from_numpy(fx[2])
    k = 140
    ids, vals = th.topk(h, k)
    _assert_same(ref_unfused[k][0], (ids, vals))
    _assert_same(ref_unfused[k][1], th.topk_logprobs(h, k))
    lay = th._lay
    ids, vals = ids.numpy(), vals.numpy()
    for i in range(B):
        valid = int((vals[i] > NEG_INF / 2).sum())
        assert valid in {40 + s for s in lay.tail_sizes}, (i, valid)
        assert np.all(ids[i][valid:] == L) and np.all(ids[i][:valid] < L)
    lp = th.topk_logprobs(h, k)[1].numpy()
    assert not np.isnan(lp).any()


@pytest.mark.parametrize("k,n_down", [(5, 0), (20, 7), (40, B), (140, B)])
def test_tier_blocks_follow_the_reference_descent_rule(fx, k, n_down):
    """``tier_blocks``: the short tier's blocks on every row, and the tail
    blocks of the rows that the reference's ``_gate`` / ``_descend_mask``
    send down (the short tier's k-th logit from numpy), the sentinel
    elsewhere (none, 7 and all of the 8 rows go down at k = 5, 20, 40);
    at k = 140 past the short list's 128 slots every row."""
    W, b, h, _ = fx
    _, th = _pair(fx)
    lay = th.layout
    short, tail, descend = th.tier_blocks(torch.from_numpy(h), k)
    ks = min(k, lay.nb0 * V_BLK)
    logits = h @ W.T + b
    svals = -np.sort(-logits[:, lay.order[:lay.F]], axis=1)[:, :ks]
    gate = jadaptive._gate(jnp.asarray(lay.g), jnp.asarray(lay.gb),
                           jnp.asarray(h))
    cluster = np.argmax(np.asarray(gate), axis=-1)
    want = np.asarray(jadaptive._descend_mask(gate, jnp.asarray(svals), ks,
                                              k))
    np.testing.assert_array_equal(descend.numpy(), want)
    np.testing.assert_array_equal(short.numpy(),
                                  np.tile(np.arange(lay.nb0), (B, 1)))
    np.testing.assert_array_equal(tail.numpy(), np.where(
        want[:, None], lay.tail_tab[cluster], lay.n_blk))
    assert want.sum() == n_down


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_shortlist_full_vocab_equals_exact(fx, fused):
    W, b, h, _ = fx
    th = heads.get("adaptive", device="cpu", W=W, b=b, shortlist=L,
                   fused=fused)
    ex = heads.get("exact", device="cpu", W=W, b=b)
    jex = jheads.get("exact", W=W, b=b)
    ht = torch.from_numpy(h)
    ids, vals = th.topk(ht, 5)
    eids, evals = ex.topk(ht, 5)
    assert torch.equal(ids, eids)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jex.topk(h, 5)[0]))
    torch.testing.assert_close(vals, evals, **TOL)
    _, lp = th.topk_logprobs(ht, 5)
    torch.testing.assert_close(lp, ex.topk_logprobs(ht, 5)[1], **TOL)


def test_sampling_row_and_draw_match_the_reference_row(fx):
    """The port's word-granular sampling row equals the reference's
    ``_tiered_row`` (ids exactly, logits within 1e-5), and ``sample`` with
    given Gumbel noise G picks argmax(row + G)."""
    jh, th = _pair(fx)
    jh.prepare()
    h = fx[2]
    jl, jids = jadaptive._tiered_row(jh._Wb, jh._bb, jh._gid,
                                     jh._short_blocks, jh._tail_tab, jh._g,
                                     jh._gb, jnp.asarray(h))
    ht = torch.from_numpy(h)
    tl, tids = th._sample_row(ht)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    shape = th.noise_shape(B, 1.0)
    assert shape == tuple(jl.shape) and th.noise_shape(B, 0.0) is None
    g = ops.gumbel_noise(shape, torch.Generator().manual_seed(1), "cpu")
    pick = np.argmax(np.asarray(jl) + g.numpy(), axis=-1)
    want = np.take_along_axis(np.asarray(jids), pick[:, None], 1)[:, 0]
    np.testing.assert_array_equal(th.sample(ht, 1.0, gumbel=g).numpy(), want)
    gen = torch.Generator().manual_seed(1)
    np.testing.assert_array_equal(th.sample(ht, 1.0, generator=gen).numpy(),
                                  want)


# -- −∞-safe recombination ----------------------------------------------------

def test_combine_tier_logz_and_masked_lse_on_infinite_rows():
    a = np.asarray([0.0, -np.inf, 1.0, -np.inf, np.inf, 3.0], np.float32)
    b = np.asarray([0.0, 2.5, -np.inf, -np.inf, 1.0, np.inf], np.float32)
    got = adaptive.combine_tier_logz(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jadaptive.combine_tier_logz(jnp.asarray(a),
                                                  jnp.asarray(b)))
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert got[3] == -np.inf
    logits = np.asarray([[1.0, 2.0, NEG_INF], [NEG_INF, NEG_INF, NEG_INF],
                         [-np.inf, 0.5, NEG_INF]], np.float32)
    got = adaptive._masked_lse(torch.from_numpy(logits))
    want = np.asarray(jadaptive._masked_lse(jnp.asarray(logits)))
    assert not torch.isnan(got).any() and got[1] == -np.inf
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# -- the per-tier kernel entry and the merge ----------------------------------

def test_tier_fused_topk_matches_the_reference(fx):
    """``tier_fused_topk`` (the plain kernel version here) against
    ``tier_fused_topk_tpu`` (Pallas, interpret mode) on block ids given
    directly: a full row, a partial row with sentinels past n_blk, and an
    all-sentinel row (NEG_INF vals, sentinel ids, logZ = −∞)."""
    W, b, h, _ = fx
    Wj, bj = j_pack(jnp.asarray(W), jnp.asarray(b))
    Wb, bb = ops.pack_head_blocks(torch.from_numpy(W), torch.from_numpy(b))
    n_blk = Wb.shape[0]
    blocks = np.tile(np.arange(n_blk, dtype=np.int32), (B, 1))
    blocks[1, 0] = n_blk + 3
    blocks[3:5] = n_blk                          # all-sentinel rows
    for k in (1, 5):
        jr, jv, jz = tier_fused_topk_tpu(Wj, bj, jnp.asarray(h),
                                         jnp.asarray(blocks), k=k,
                                         interpret=True)
        tr, tv, tz = ops.tier_fused_topk(Wb, bb, torch.from_numpy(h),
                                         torch.from_numpy(blocks), k=k)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
        assert (tr[3:5] == n_blk * V_BLK).all() and (tv[3:5] <= NEG_INF / 2
                                                       ).all()
        assert torch.isneginf(tz[3:5]).all() and not torch.isnan(tz).any()


@pytest.mark.parametrize("k", [1, 4, 12, 20])
def test_merge_shard_topk_matches_the_reference(k):
    """Ties (quantised values) go to the lowest position; past the
    candidates the merge pads with (NEG_INF, sentinel). The values hold no
    −0.0: XLA's top_k orders −0.0 below +0.0, the port (and its CUDA
    kernels) take them as equal (ROADMAP.md Queue 3)."""
    rng = np.random.default_rng(k)
    vals = -np.sort(-np.round(rng.standard_normal((6, 3, 4)) * 2) / 2,
                    axis=-1).reshape(6, 12).astype(np.float32) + 0.0
    ids = rng.integers(0, 500, (6, 12)).astype(np.int32)
    ji, jv = j_merge(jnp.asarray(vals), jnp.asarray(ids), k, sentinel=999)
    ti, tv = merge_shard_topk(torch.from_numpy(vals), torch.from_numpy(ids),
                              k, sentinel=999)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- cost model and routing metadata ------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("counts", ["uniform", "zipf3", "none"])
def test_cost_model_and_describe_match_the_reference(fx, counts, fused):
    W, b, _, _ = fx
    c = {"uniform": np.ones(L), "zipf3": 1e6 / np.arange(1, L + 1) ** 3.0,
         "none": None}[counts]
    kw = dict(W=W, b=b, counts=c, shortlist=40, n_tails=3, fused=fused)
    want = jheads.get("adaptive", **kw).describe()
    got = heads.get("adaptive", device="cpu", **kw).describe()
    want["device_kind"] = "torch"                 # the framework's name
    assert got == want
    args = (40, 3, 0.25, 37.5, D)
    assert (base.tiered_flops_per_query(*args) ==
            jbase.tiered_flops_per_query(*args))
    assert (base.tiered_bytes_per_query(*args, writeback_floats=256.0) ==
            jbase.tiered_bytes_per_query(*args, writeback_floats=256.0))


def test_registry_factory_and_step_key(fx):
    """The factory ignores foreign engine context; the step key tells heads
    over the same weights apart by short-list, tails, counts and path, and
    is stable over a transient instance."""
    W, b, h, counts = fx
    Wt, bt = torch.from_numpy(W), torch.from_numpy(b)
    hd = heads.get("adaptive", device="cpu", W=Wt, b=bt, screen=None,
                   rho=16, counts=counts, shortlist=40)
    assert hd.topk(torch.from_numpy(h), 5)[0].shape == (B, 5)
    keys = {heads.get("adaptive", device="cpu", W=Wt, b=bt, **kw).step_key()
            for kw in (dict(counts=counts, shortlist=40),
                       dict(counts=counts, shortlist=41),
                       dict(counts=counts, shortlist=40, n_tails=2),
                       dict(counts=np.ones(L), shortlist=40),
                       dict(counts=counts, shortlist=40, fused=False))}
    assert len(keys) == 5 and hd.step_key() in keys
    assert "adaptive" in heads.names()


# -- the fused kernel's parts rule ---------------------------------------------

def test_fused_parts_fit_the_shared_memory_limit():
    """P is the grid rule's, halved until the merge fits 227 KB; past that
    even at P = 1 the wrapper raises a ValueError naming the limit."""
    assert fused_parts(4, 16, 132, 5, 500) == 8        # the decode step
    assert fused_parts(1, 250, 132, 56, 2560) == 2     # fits at P = 2
    assert fused_parts(1, 250, 132, 57, 2560) == 1     # P = 2 would not
    assert fused_parts(1, 250, 132, 64, 2560) == 1
    assert merge_smem_bytes(250, 2, 64, 2560) > SMEM_LIMIT
    assert merge_smem_bytes(250, 1, 64, 2560) <= SMEM_LIMIT
    assert fused_parts(4, 196, 132, 128, 500) == 1     # nmt-deen, all tiles
    assert fused_parts(1, 16, 132, 5, 500) == 8
    for B_, K_, k_ in ((1, 250, 64), (1, 45, 5), (4, 196, 128), (2, 224, 128)):
        p = fused_parts(B_, K_, 132, k_, 2560)
        assert merge_smem_bytes(K_, p, k_, 2560) <= SMEM_LIMIT
    with pytest.raises(ValueError, match="227 KB"):
        fused_parts(1, 250, 132, 128, 2560)
    with pytest.raises(ValueError, match="227 KB"):
        fused_parts(1, 225, 132, 128, 500)


# -- decode through the engine ---------------------------------------------------

@pytest.fixture(scope="module")
def lstm():
    return lstm_fx()


def test_engine_adaptive_greedy_and_beam_match_the_reference(lstm):
    """Greedy tokens and the top beam of the port's engine through
    ``adaptive`` (fused, plain kernel versions) equal the JAX engine's
    through its unfused ``adaptive`` (the same ids as its fused path), with
    counts from a Zipf unigram over the reduced nmt-deen-lstm."""
    from repro.serving.engine import DecodeEngine as JEngine
    from repro_torch.serving import DecodeEngine
    V = lstm["vocab"]
    counts = np.random.default_rng(2).permutation(
        1e6 / np.arange(1, V + 1) ** 1.2)
    kw = dict(counts=counts, shortlist=200, n_tails=3)
    jeng = JEngine(lstm["jmodel"], lstm["jparams"], max_len=32,
                   head_kwargs=dict(kw, fused=False))
    teng = DecodeEngine(lstm["tmodel"], lstm["tparams"], max_len=32,
                        device="cpu", head_kwargs=kw)
    p = prompts(lstm, 3, 6, 1)
    got = teng.generate(p, 8, head="adaptive")
    np.testing.assert_array_equal(
        got.tokens, jeng.generate(p, 8, head="adaptive").tokens)
    gb = teng.beam_search(p[0], 3, 5, head="adaptive")
    jb = jeng.beam_search(p[0], 3, 5, head="adaptive")
    np.testing.assert_array_equal(gb.tokens, jb.tokens)
    np.testing.assert_allclose(gb.scores, jb.scores, rtol=1e-5, atol=1e-4)
    assert teng.compiled_step_counts() == {("adaptive", "greedy"): 0,
                                           ("adaptive", "decode"): 0}
