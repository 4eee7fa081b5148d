"""The port in bfloat16 and on long prompts, against the JAX package on the
same numpy inputs:

  * ``_sdpa_chunked`` (query chunks of 16, 32 and 64, tail padded; window
    7) against the reference's and against the port's own ``_sdpa`` with
    the same mask: atol = 2e-5, rtol = 1e-4 (the reference's own
    chunked-vs-full bound); ``attn_forward_kv`` at T = 2,048 (the chunked
    path) and a reduced ``zamba2-2.7b`` prefill of 2,048 tokens against
    the reference: atol = 1e-4, in float32 (the point is the algorithm);
  * the plain bfloat16 route, gather and fused versions against the Pallas
    kernels in interpret mode on bf16 inputs (f32 v for the route): routes
    equal (each bf16 product is exact in float32, so only the order of the
    float32 sums differs: tighter than the reference tests' 97 %); logits
    within 1e-4·√d (the reference tests allow 0.3·√d); fused ids equal,
    values and logZ within 1e-4;
  * the plain fused version at the shapes the CUDA merge once refused (K =
    225 and 250 tiles, k = 115, 128, 129) against the reference's gather
    kernel + ``jax.lax.top_k``, on a 0.5 grid (every sum exact): ids and
    values equal;
  * the reduced ``zamba2-2.7b`` and ``mamba2-1.3b`` with
    ``dtype="bfloat16"`` on both sides, the reference's bf16 weights
    carried across bit for bit (and back, through ``params_to_numpy(...,
    bf16=ml_dtypes.bfloat16)``): hidden states of ``prefill`` and of 5
    ``decode_step``s (fed the reference's exact greedy tokens) within 5 %
    of max |h| (the two frameworks round bf16
    at different places; 1.3 % measured on these models' forward), and
    greedy ``generate`` on ``exact`` and ``screened-cuda`` (bf16 caches):
    tokens equal except where a row first differs after a step whose
    reference top-2 gap is below the bf16 margin 0.5 (3 × the largest
    logit difference measured between the two forwards, 0.164, at logits
    up to 18.75); such rows are counted;
  * ``Model.init_cache`` defaults to bfloat16, as the reference's does;
  * the NEG_INF pad bias of a bf16 packed head (about −1.0e30) never wins
    top-k; the adaptive head on a bf16 model builds its tiers in float32
    (as the reference does) and answers as on the float32-widened weights,
    and a host head (svd) takes a bf16 W and h, exactly.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.screening import ScreenParams as JScreen
from repro.core.screening import candidates_to_padded
from repro.kernels.fused_topk import fused_screened_topk as j_fused
from repro.kernels.route import cluster_route_pallas
from repro.kernels.screen import screened_logits_pallas
from repro.layers import attention as jattn
from repro.models.model import Model as JModel
from repro.serving.engine import DecodeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 screen_from_numpy)
from repro_torch.kernels.fused_topk import fused_screened_topk
from repro_torch.kernels.route import cluster_route
from repro_torch.kernels.screen import screened_logits
from repro_torch.layers import attention as tattn
from repro_torch.models import Model
from repro_torch.serving import DecodeEngine
from repro_torch.tree import tree_leaves

V_BLK = 128
BF16_MARGIN = 0.5
H_REL = 0.05


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(a):
    """A numpy array's values, or a bf16 array's or tensor's raw bits."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16).numpy().view(np.uint16)
                if a.dtype == torch.bfloat16 else a.numpy())
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# -- attention: the chunked path ---------------------------------------------------

@pytest.mark.parametrize("q_chunk,window", [(16, None), (32, None),
                                            (64, None), (16, 7)])
def test_sdpa_chunked_matches_reference(q_chunk, window):
    """60 query positions (a padded tail at every chunk size), 4 heads over
    2 KV heads."""
    tcfg = replace(get_config("zamba2-2.7b").reduced(), num_kv_heads=2)
    rng = np.random.default_rng(q_chunk + (window or 0))
    q = rng.standard_normal((2, 60, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 60, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 60, 2, 16)).astype(np.float32)
    want = jattn._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None, causal=True, window=window,
                               q_chunk=q_chunk)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn._sdpa_chunked(tq, tk, tv, tcfg, causal=True, window=window,
                              q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    full = tattn._sdpa(tq, tk, tv, tattn.make_mask(60, 60, True, window), tcfg)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=2e-5,
                               rtol=1e-4)


def test_attn_forward_kv_at_2048_matches_reference():
    """T = 2,048 takes the chunked path on both sides (no NotImplemented)."""
    jcfg = j_get_config("zamba2-2.7b").reduced()
    tcfg = get_config("zamba2-2.7b").reduced()
    T = tattn.CHUNKED_ATTN_THRESHOLD
    jp = jattn.attn_init(jax.random.key(3), jcfg)
    tp = params_from_numpy(_np_tree(jp))
    x = np.random.default_rng(3).standard_normal(
        (1, T, jcfg.d_model)).astype(np.float32)
    pos = np.arange(T, dtype=np.int32)[None]
    want = jattn.attn_forward_kv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = tattn.attn_forward_kv(tp, torch.from_numpy(x), tcfg,
                                torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_long_prefill_matches_reference():
    """A reduced zamba2-2.7b prefill of 2,048 tokens (128 SSD chunks, the
    shared attention's chunked path) in float32: hidden states and the K/V
    cache within 1e-4 of the reference's."""
    jcfg = j_get_config("zamba2-2.7b").reduced()
    tcfg = get_config("zamba2-2.7b").reduced()
    T = 2048
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.key(11))
    tp = params_from_numpy(_np_tree(jp))
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (1, T))
    jcache = jm.init_cache(1, T + 8, dtype=jnp.float32)
    jh, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                           jcache)
    tcache = tm.init_cache(1, T + 8, dtype=torch.float32, device="cpu")
    th, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcache)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(tcache["shared_attn"]["k"].numpy(),
                               np.asarray(jcache["shared_attn"]["k"]),
                               atol=1e-4)


# -- the three L2S kernels' plain versions in bfloat16 ------------------------------

def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _torch_bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def test_bf16_plain_route_gather_fused_match_pallas():
    rng = np.random.default_rng(21)
    n_blk, d, B, K, r = 6, 96, 5, 4, 40
    W = rng.standard_normal((n_blk, V_BLK, d)) * 0.1
    b = rng.standard_normal((n_blk, V_BLK)) * 0.1
    h = rng.standard_normal((B, d))
    v = rng.standard_normal((r, d)).astype(np.float32)
    ids = rng.integers(0, n_blk + 2, (B, K)).astype(np.int32)
    ids[-1] = n_blk                                  # an all-sentinel row
    # bf16 values shared by both sides
    W, b, h = (np.asarray(_bf16(a), np.float32) for a in (W, b, h))
    tW, tb, th = _torch_bf16(W), _torch_bf16(b), _torch_bf16(h)
    route = cluster_route(th, torch.from_numpy(v))
    want = cluster_route_pallas(_bf16(h), jnp.asarray(v))
    np.testing.assert_array_equal(route.numpy(), np.asarray(want))
    got = screened_logits(tW, tb, th, torch.from_numpy(ids))
    assert got.dtype == torch.float32
    want = screened_logits_pallas(_bf16(W), _bf16(b), _bf16(h),
                                  jnp.asarray(ids))
    valid = (ids < n_blk)[..., None]
    np.testing.assert_allclose(np.where(valid, got.numpy(), 0),
                               np.where(valid, np.asarray(want), 0),
                               atol=1e-4 * np.sqrt(d), rtol=0)
    for k in (1, 7):
        ti, tv, tz = fused_screened_topk(tW, tb, th, torch.from_numpy(ids), k)
        ji, jv, jz = j_fused(_bf16(W), _bf16(b), _bf16(h), jnp.asarray(ids), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-4)


@pytest.mark.parametrize("K", [225, 250])
@pytest.mark.parametrize("k", [115, 128, 129])
def test_fused_plain_serves_the_shapes_the_merge_refused(K, k):
    """B = 2, d = 8, 250 tiles, one row with sentinels mid-row; weights and
    h on a 0.5 grid, so every logit is exact on both sides."""
    rng = np.random.default_rng(K + k)
    n_blk, d = 250, 8
    W = np.round(rng.standard_normal((n_blk, V_BLK, d)) * 2) / 2
    b = np.zeros((n_blk, V_BLK))
    h = np.round(rng.standard_normal((2, d))) * 0.5
    ids = np.stack([rng.permutation(n_blk)[:K] for _ in range(2)]).astype(
        np.int32)
    ids[1, K // 2] = n_blk
    tW, tb, th = (torch.from_numpy(a.astype(np.float32)) for a in (W, b, h))
    ti, tv, _ = fused_screened_topk(tW, tb, th, torch.from_numpy(ids), k)
    raw = np.asarray(screened_logits_pallas(
        jnp.asarray(W, jnp.float32), jnp.asarray(b, jnp.float32),
        jnp.asarray(h, jnp.float32), jnp.asarray(ids)))
    valid = (ids < n_blk)[..., None]
    row = np.where(valid, raw, -1e30).reshape(2, -1)
    word = np.where(valid, ids[..., None] * V_BLK + np.arange(V_BLK),
                    n_blk * V_BLK).reshape(2, -1)
    jv, jpos = jax.lax.top_k(jnp.asarray(row), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        ti.numpy(), np.take_along_axis(word, np.asarray(jpos), axis=1))


# -- the reduced SSM and hybrid models in bfloat16 -----------------------------------

def _build(name):
    jcfg = replace(j_get_config(name).reduced(), dtype="bfloat16")
    tcfg = replace(get_config(name).reduced(), dtype="bfloat16")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(7))
    jp["embed"]["embedding"] = jp["embed"]["embedding"] * 20.0
    vocab, d = jcfg.vocab_size, jcfg.d_model
    rng = np.random.default_rng(7)
    r, n_blk = 4, vocab // V_BLK
    mask = np.zeros((r, n_blk), bool)
    mask[0, [0, 3]] = True
    mask[1, 1:3] = True
    mask[2, :] = True
    mask[3, [1, 3]] = True
    idx, lens = candidates_to_padded(mask, vocab, block=V_BLK)
    v = (rng.standard_normal((r, d)) * 3).astype(np.float32)
    return dict(jm=jm, jp=jp, tm=Model(tcfg),
                tp=params_from_numpy(_np_tree(jp)),
                jscreen=JScreen(v=jnp.asarray(v), cand_idx=jnp.asarray(idx),
                                cand_len=jnp.asarray(lens), vocab_size=vocab,
                                block=V_BLK),
                tscreen=screen_from_numpy(v, idx, lens, vocab, V_BLK),
                v=v, word_mask=np.repeat(mask, V_BLK, axis=1)[:, :vocab],
                prompts=rng.integers(0, vocab, (2, 40)).astype(np.int32))


@pytest.fixture(scope="module", params=["zamba2-2.7b", "mamba2-1.3b"])
def bfx(request):
    """One reduced bf16 model a parameter, with both packages' engines
    (bf16 caches of 64 slots) shared by the tests of it."""
    fx = _build(request.param)
    fx["jeng"] = JEngine(fx["jm"], fx["jp"], screen=fx["jscreen"], max_len=64,
                         cache_dtype=jnp.bfloat16)
    fx["teng"] = DecodeEngine(fx["tm"], fx["tp"], screen=fx["tscreen"],
                              max_len=64, cache_dtype=torch.bfloat16,
                              device="cpu")
    fx["memo"] = {}
    return fx


def test_bf16_weights_cross_bit_for_bit(bfx):
    """The reference's bf16 leaves arrive as torch.bfloat16 with the same
    bits (A_log, D and dt_bias float32 on both sides), and go back to
    numpy bfloat16 with the same bits; the port's own init draws bf16."""
    ref = jax.tree_util.tree_leaves(_np_tree(bfx["jp"]))
    port = tree_leaves(bfx["tp"])
    assert {str(a.dtype) for a in ref} == {"bfloat16", "float32"}
    for a, t in zip(ref, port):
        assert str(t.dtype) == f"torch.{a.dtype}"
        np.testing.assert_array_equal(_bits(t), _bits(a))
    back = jax.tree_util.tree_leaves(params_to_numpy(bfx["tp"],
                                                     bf16=ml_dtypes.bfloat16))
    for a, c in zip(ref, back):
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(_bits(c), _bits(a))
    own = bfx["tm"].init(torch.Generator().manual_seed(0), device="cpu")
    assert {t.dtype for t in tree_leaves(own)} == {torch.bfloat16,
                                                   torch.float32}
    assert own["embed"]["embedding"].dtype == torch.bfloat16
    assert get_config(bfx["tm"].cfg.name[:-len("-reduced")]).dtype == \
        "bfloat16"


def _want(bfx, jname):
    """The reference engine's greedy tokens (2, 6) through ``jname``."""
    key = ("want", jname)
    if key not in bfx["memo"]:
        bfx["memo"][key] = np.asarray(
            bfx["jeng"].generate(bfx["prompts"], 6, head=jname).tokens)
    return bfx["memo"][key]


def _ref_path(bfx, tokens):
    """The reference's prefill hidden states over the prompts (2, 40, d)
    and the hidden state before each greedy step that produced ``tokens``
    (2, n, d): its engine's compiled prefill and decode steps fed the
    tokens, through a bf16 cache of 64 slots, as its ``generate`` ran
    them."""
    key = ("path", tokens.tobytes())
    if key not in bfx["memo"]:
        jeng, jp, prompts = bfx["jeng"], bfx["jp"], bfx["prompts"]
        T = prompts.shape[1]
        cache = bfx["jm"].init_cache(len(prompts), 64, dtype=jnp.bfloat16)
        h, cache = jeng._jit_prefill(jp, {"tokens": jnp.asarray(prompts)},
                                     cache)
        hs = [h[:, -1]]
        for i in range(tokens.shape[1] - 1):
            h1, cache = jeng._jit_decode(
                jp, jnp.asarray(tokens[:, i], jnp.int32), cache, T + i)
            hs.append(h1)
        bfx["memo"][key] = (h, jnp.stack(hs, axis=1))
    return bfx["memo"][key]


def test_bf16_prefill_and_decode_match_reference(bfx):
    """The port's prefill over the prompts and 5 decode steps fed the
    reference's exact greedy tokens: each hidden state within 5 % of the
    reference's max |h|."""
    tm, tp, toks = bfx["tm"], bfx["tp"], bfx["prompts"]
    tokens = _want(bfx, "exact")
    jh, jsteps = _ref_path(bfx, tokens)
    tcache = tm.init_cache(2, 64, device="cpu")
    th, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcache)
    assert th.dtype == torch.bfloat16

    def close(t, j):
        j = np.asarray(j, np.float32)
        assert np.abs(t.float().numpy() - j).max() <= H_REL * np.abs(j).max()
    close(th, jh)
    for i in range(tokens.shape[1] - 1):
        th1, tcache = tm.decode_step(tp, torch.from_numpy(tokens[:, i]),
                                     tcache, 40 + i)
        close(th1, jsteps[:, i + 1])


@pytest.mark.parametrize("tname,jname", [("exact", "exact"),
                                         ("screened-cuda", "screened-pallas")])
def test_bf16_greedy_matches_reference(bfx, tname, jname):
    """Both engines with bf16 weights and bf16 caches."""
    prompts = bfx["prompts"]
    want = _want(bfx, jname)
    got = bfx["teng"].generate(prompts, 6, head=tname).tokens
    _, h = _ref_path(bfx, want)
    logits = np.asarray(bfx["jm"].logits(bfx["jp"], h), np.float32)
    if tname != "exact":
        scores = np.asarray(h, np.float32) @ bfx["v"].T
        logits = np.where(bfx["word_mask"][scores.argmax(-1)], logits,
                          -np.inf)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gaps = top2[..., 1] - top2[..., 0]
    near = 0
    for i in range(len(prompts)):
        bad = np.nonzero(got[i] != want[i])[0]
        if bad.size:
            assert gaps[i, bad[0]] < BF16_MARGIN, (i, bad[0], gaps[i, bad[0]])
            near += 1
    print(f"{tname}: rows that first differ after a near tie: {near}")


def test_init_cache_defaults_to_bfloat16():
    """As the reference's ``Model.init_cache``: the K/V caches (and the
    LSTM state) in bfloat16 unless asked; conv tails and SSM states
    float32."""
    for name in ("zamba2-2.7b", "ptb-small-lstm"):
        jcache = JModel(j_get_config(name).reduced()).init_cache(2, 16)
        tcache = Model(get_config(name).reduced()).init_cache(2, 16,
                                                              device="cpu")
        if name == "ptb-small-lstm":
            assert {str(a.dtype) for a in jax.tree_util.tree_leaves(jcache)} \
                == {"bfloat16"}
            assert {t.dtype for t in tree_leaves(tcache)} == {torch.bfloat16}
            continue
        assert str(jcache["shared_attn"]["k"].dtype) == "bfloat16"
        assert tcache["shared_attn"]["k"].dtype == torch.bfloat16
        assert tcache["shared_attn"]["v"].dtype == torch.bfloat16
        assert tcache["ssm"]["state"].dtype == torch.float32
        assert tcache["ssm"]["conv_tail"].dtype == torch.float32


# -- heads on a bfloat16 model ---------------------------------------------------------

def test_bf16_pack_pads_with_a_loser():
    """``pack_head_blocks`` keeps bf16; the NEG_INF pad bias rounds to about
    −1.0e30 in bf16 and still never wins top-k, even against very negative
    real logits, in the plain fused version."""
    from repro_torch.kernels.ops import pack_head_blocks
    L, d = 200, 16
    W = torch.zeros((L, d), dtype=torch.bfloat16)
    b = torch.full((L,), -1e20, dtype=torch.bfloat16)
    Wb, bb = pack_head_blocks(W, b)
    assert Wb.dtype == bb.dtype == torch.bfloat16 and Wb.shape[0] == 2
    pad = bb[1, L - V_BLK:]
    assert bool((pad < -0.99e30).all() & (pad > -1.01e30).all())
    ids, vals, _ = fused_screened_topk(Wb, bb, torch.zeros((1, d),
                                                           dtype=torch.bfloat16),
                                       torch.tensor([[1, 0]], dtype=torch.int32),
                                       k=L)
    assert int(ids.max()) < L and bool((vals > -1e21).all())


def test_adaptive_and_host_heads_take_a_bf16_model():
    """The adaptive head builds its tiers in float32 from a bf16 W (as the
    reference builds them in np.float32) and scores a bf16 h as float32, so
    it answers as on the float32-widened weights, fused and unfused; a host
    head (svd) takes a bf16 W and h, widened to float32."""
    from repro_torch import heads
    rng = np.random.default_rng(31)
    L, d = 700, 24
    W = _torch_bf16(rng.standard_normal((L, d)))
    b = _torch_bf16(rng.standard_normal(L) * 0.1)
    h = _torch_bf16(rng.standard_normal((3, d)))
    counts = rng.zipf(1.3, L).astype(np.float64)
    for fused in (True, False):
        kw = dict(counts=counts, shortlist=256, n_tails=2, fused=fused)
        got = heads.get("adaptive", device="cpu", W=W, b=b, **kw).topk(h, 5)
        want = heads.get("adaptive", device="cpu", W=W.float(), b=b.float(),
                         **kw).topk(h.float(), 5)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    svd = heads.get("svd", device="cpu", W=W, b=b)
    ref = heads.get("svd", device="cpu", W=W.float(), b=b.float())
    for g, w in zip(svd.topk(h, 5), ref.topk(h.float(), 5)):
        assert torch.equal(g, w)
