"""The port's attention, RoPE, MLP and norm layers and the reduced
``zamba2-2.7b`` (hybrid) and ``mamba2-1.3b`` (ssm) models against the JAX
package's, on weights initialised in JAX and carried across with
``params_from_numpy``:

  * ``attn_forward_kv`` / ``attn_decode`` (scalar pos, its cache write
    through ``cache_slot_update``), ``apply_rope``, ``mlp_apply``,
    ``norm_apply``: atol = 1e-4 (1e-5 for the elementwise layers);
    ``attn_decode`` with a (B,) tensor of per-row positions against the
    reference's vector branch, atol = 1e-5, and with a 0-dim or aligned
    tensor pos bit for bit against its own int path;
  * end to end, reduced configs (d = 128, chunk 16): hidden states of
    ``forward``, ``prefill`` and 3 ``decode_step``s within atol = 1e-4;
    greedy tokens of ``DecodeEngine(device="cpu")`` through ``exact`` and
    ``screened-cuda`` (fused and unfused) equal the JAX engine's through
    ``exact`` and ``screened-pallas`` on prompts of 40 tokens (3 chunks of
    16, the last padded); beam 4 gives the same top beam, its score within
    1e-4. The fixture asserts that every decided step has a top-2 gap above
    1e-4 (logits, and cluster scores on the screened path). Past
    ``max_len`` the hybrid engine refuses and the SSM engine decodes, with
    the reference's tokens.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.screening import ScreenParams as JScreen
from repro.core.screening import candidates_to_padded
from repro.layers import attention as jattn
from repro.layers import mlp as jmlp
from repro.layers import norms as jnorms
from repro.layers import rope as jrope
from repro.models.model import Model as JModel
from repro.serving.engine import DecodeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, screen_from_numpy
from repro_torch.kernels import ops
from repro_torch.layers import attention as tattn
from repro_torch.layers import mlp as tmlp
from repro_torch.layers import norms as tnorms
from repro_torch.layers import rope as trope
from repro_torch.layers.lstm import lstm_init_state
from repro_torch.models import Model
from repro_torch.serving import DecodeEngine

V_BLK = 128
GAP = 1e-4
B, TP, NEW, MAX_LEN = 3, 40, 8, 64


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- layers -----------------------------------------------------------------------

def test_attention_forward_and_decode_match_reference():
    cfg = j_get_config("zamba2-2.7b").reduced()
    tcfg = get_config("zamba2-2.7b").reduced()
    jp = jattn.attn_init(jax.random.key(5), cfg)
    tp = params_from_numpy(_np_tree(jp))
    rng = np.random.default_rng(5)
    T = 12
    x = rng.standard_normal((2, T + 3, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T))
    jo, jk, jv = jattn.attn_forward_kv(jp, jnp.asarray(x[:, :T]), cfg,
                                       jnp.asarray(pos))
    to, tk, tv = tattn.attn_forward_kv(tp, _t(x[:, :T]), tcfg, _t(pos))
    for got, want in ((to, jo), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    S = 20
    jc = jattn.init_cache(cfg, 2, S, jnp.float32)
    jc = {k: jc[k].at[:, :T].set(w) for k, w in (("k", jk), ("v", jv))}
    tc = tattn.init_cache(tcfg, 2, S, torch.float32)
    tc["k"][:, :T], tc["v"][:, :T] = tk, tv
    for i in range(3):
        x1 = x[:, T + i:T + i + 1]
        jo, jc = jattn.attn_decode(jp, jnp.asarray(x1), jc, T + i, cfg)
        to, tc2 = tattn.attn_decode(tp, _t(x1), tc, T + i, tcfg)
        assert tc2["k"] is tc["k"]                  # written in place
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4)
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=1e-4)
    # a tensor pos: rows at different depths against the reference's
    # vector branch, within atol = 1e-5 (the reference's own attention
    # decode tolerance; its bit-identity test fails at the seed); a 0-dim
    # and an aligned (B,) pos bit for bit against the port's own int path
    x1 = x[:, T + 2:T + 3]
    pvec = np.asarray([T + 3, T + 1], np.int32)
    jo, jcv = jattn.attn_decode(jp, jnp.asarray(x1), jc, jnp.asarray(pvec),
                                cfg)
    tcv = {k: a.clone() for k, a in tc.items()}
    to, _ = tattn.attn_decode(tp, _t(x1), tcv, _t(pvec), tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcv[k].numpy(), np.asarray(jcv[k]),
                                   atol=1e-5)
    want = {k: a.clone() for k, a in tc.items()}
    wo, _ = tattn.attn_decode(tp, _t(x1), want, T + 3, tcfg)
    for pos in (torch.tensor(T + 3, dtype=torch.int32),
                torch.full((2,), T + 3, dtype=torch.int32)):
        got = {k: a.clone() for k, a in tc.items()}
        go, _ = tattn.attn_decode(tp, _t(x1), got, pos, tcfg)
        assert torch.equal(go, wo)
        assert all(torch.equal(got[k], want[k]) for k in ("k", "v"))
    with pytest.raises(ValueError, match="pos must be"):
        tattn.attn_decode(tp, _t(x1), tc, torch.tensor([1, 2, 3]), tcfg)
    assert ops.LAUNCHES["cache_slot_update"] == 0


def test_rope_mlp_norms_match_reference():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 600, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        trope.apply_rope(_t(x), _t(pos)).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos))), atol=1e-5)
    base = j_get_config("zamba2-2.7b").reduced()
    h = rng.standard_normal((2, 5, base.d_model)).astype(np.float32)
    for act in ("gelu", "relu", "swiglu", "geglu"):
        cfg = replace(base, mlp_activation=act)
        jp = jmlp.mlp_init(jax.random.key(1), cfg)
        got = tmlp.mlp_apply(params_from_numpy(_np_tree(jp)), _t(h),
                             replace(get_config("zamba2-2.7b").reduced(),
                                     mlp_activation=act))
        np.testing.assert_allclose(got.numpy(), np.asarray(
            jmlp.mlp_apply(jp, jnp.asarray(h), cfg)), atol=1e-5)
    for kind in ("rmsnorm", "layernorm"):
        jp = {k: v + 0.5 for k, v in jnorms.norm_init(base.d_model, kind).items()}
        got = tnorms.norm_apply(params_from_numpy(_np_tree(jp)), _t(h), kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(
            jnorms.norm_apply(jp, jnp.asarray(h), kind)), atol=1e-5)


def test_cache_entry_points_need_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    for name in ("zamba2-2.7b", "nmt-deen-lstm"):
        cfg = get_config(name).reduced()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(cfg).init_cache(2, 16)
        assert Model(cfg).init_cache(2, 16, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lstm_init_state(get_config("nmt-deen-lstm").reduced(), 2)


# -- end to end ---------------------------------------------------------------------

def _build(name):
    jcfg, tcfg = j_get_config(name).reduced(), get_config(name).reduced()
    vocab, d = jcfg.vocab_size, jcfg.d_model
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(7))
    # sharper logits than the 0.02-scale (tied) embedding gives, so greedy
    # steps are decided by gaps far above float32 rounding (asserted below)
    jparams["embed"]["embedding"] = jparams["embed"]["embedding"] * 20.0
    rng = np.random.default_rng(7)
    r, n_blk = 4, vocab // V_BLK
    mask = np.zeros((r, n_blk), bool)
    mask[0, [0, 3]] = True
    mask[1, 1:3] = True
    mask[2, :] = True
    mask[3, [1, 3]] = True
    idx, lens = candidates_to_padded(mask, vocab, block=V_BLK)
    v = (rng.standard_normal((r, d)) * 3).astype(np.float32)
    return dict(
        jmodel=jmodel, jparams=jparams, tmodel=Model(tcfg),
        tparams=params_from_numpy(_np_tree(jparams)), v=v,
        jscreen=JScreen(v=jnp.asarray(v), cand_idx=jnp.asarray(idx),
                        cand_len=jnp.asarray(lens), vocab_size=vocab,
                        block=V_BLK),
        tscreen=screen_from_numpy(v, idx, lens, vocab, V_BLK),
        word_mask=np.repeat(mask, V_BLK, axis=1)[:, :vocab],
        prompts=rng.integers(0, vocab, (B, TP)).astype(np.int32))


@pytest.fixture(scope="module", params=["zamba2-2.7b", "mamba2-1.3b"])
def fx(request):
    return _build(request.param)


def _top2_gap(x):
    s = np.sort(np.asarray(x, np.float64), axis=-1)
    return s[..., -1] - s[..., -2]


def _assert_decided(fx, prompts, tokens, screened, cache_dtype=None):
    """Every step of the path the reference took is decided by a margin:
    top-2 logit gap (within the routed candidates on the screened path)
    and, when screened, top-2 cluster-score gap. With ``cache_dtype`` the
    hidden states are the reference's prefill + decode steps through caches
    of that dtype, the path its engine took."""
    jm, jp = fx["jmodel"], fx["jparams"]
    if cache_dtype is None:
        seq = np.concatenate([prompts, tokens[:, :-1]], axis=1)
        h, _ = jm.forward(jp, {"tokens": jnp.asarray(seq)})
        h = np.asarray(h)[:, prompts.shape[1] - 1:]
    else:
        Tp = prompts.shape[1]
        cache = jm.init_cache(len(prompts), MAX_LEN, dtype=cache_dtype)
        h0, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)}, cache)
        hs = [np.asarray(h0[:, -1])]
        for i in range(tokens.shape[1] - 1):
            h1, cache = jm.decode_step(jp, jnp.asarray(tokens[:, i]), cache,
                                       Tp + i)
            hs.append(np.asarray(h1))
        h = np.stack(hs, axis=1)
    logits = np.asarray(fx["jmodel"].logits(fx["jparams"], jnp.asarray(h)))
    if screened:
        scores = h @ fx["v"].T
        assert _top2_gap(scores).min() > GAP
        logits = np.where(fx["word_mask"][scores.argmax(-1)], logits, -np.inf)
    assert _top2_gap(logits).min() > GAP


def test_model_hidden_states_match(fx):
    jm, jp, tm, tp = fx["jmodel"], fx["jparams"], fx["tmodel"], fx["tparams"]
    toks = fx["prompts"]
    jh, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    th, _ = tm.forward(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)

    jcache = jm.init_cache(B, MAX_LEN, dtype=jnp.float32)
    jh, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcache)
    tcache = tm.init_cache(B, MAX_LEN, dtype=torch.float32, device="cpu")
    th, tcache = tm.prefill(tp, {"tokens": _t(toks)}, tcache)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    tok = toks[:, -1]
    for i in range(3):
        jh1, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache, TP + i)
        th1, tcache = tm.decode_step(tp, _t(tok), tcache, TP + i)
        np.testing.assert_allclose(th1.numpy(), np.asarray(jh1), atol=1e-4)
        tok = (tok * 7 + i) % fx["tmodel"].cfg.vocab_size
    for path in (("ssm", "state"), ("ssm", "conv_tail"), ("shared_attn", "k")):
        if path[0] in jcache:
            np.testing.assert_allclose(tcache[path[0]][path[1]].numpy(),
                                       np.asarray(jcache[path[0]][path[1]]),
                                       atol=1e-4)


@pytest.mark.parametrize("tname,jname,kw", [
    ("exact", "exact", {}),
    ("screened-cuda", "screened-pallas", {"fused": True}),
    ("screened-cuda", "screened-pallas", {"fused": False}),
], ids=["exact", "cuda-fused", "cuda-unfused"])
def test_greedy_generate_and_beam_match_reference(fx, tname, jname, kw):
    jeng = JEngine(fx["jmodel"], fx["jparams"], screen=fx["jscreen"],
                   max_len=MAX_LEN, head_kwargs=kw)
    teng = DecodeEngine(fx["tmodel"], fx["tparams"], screen=fx["tscreen"],
                        max_len=MAX_LEN, head_kwargs=kw, device="cpu")
    want = jeng.generate(fx["prompts"], NEW, head=jname).tokens
    _assert_decided(fx, fx["prompts"], want, screened=tname != "exact")
    got = teng.generate(fx["prompts"], NEW, head=tname).tokens
    np.testing.assert_array_equal(got, np.asarray(want))

    jb = jeng.beam_search(fx["prompts"][0], 4, 6, head=jname)
    tb = teng.beam_search(fx["prompts"][0], 4, 6, head=tname)
    np.testing.assert_array_equal(tb.tokens, jb.tokens)
    np.testing.assert_allclose(tb.scores, jb.scores, rtol=0, atol=1e-4)
    assert not any(ops.LAUNCHES.values())           # no kernel on the CPU
    # past max_len: the hybrid's K/V cache refuses; the SSM state does not
    # grow, and decodes on as the reference does
    if fx["tmodel"].cfg.family == "hybrid":
        with pytest.raises(ValueError, match="max_len"):
            teng.generate(fx["prompts"], MAX_LEN, head=tname)
    else:
        want = jeng.generate(fx["prompts"], MAX_LEN, head=jname).tokens
        _assert_decided(fx, fx["prompts"], want, screened=tname != "exact")
        got = teng.generate(fx["prompts"], MAX_LEN, head=tname).tokens
        np.testing.assert_array_equal(got, np.asarray(want))


def test_decode_past_max_len(fx):
    """A prompt of 10 tokens and 5 new ones with max_len = 8: the SSM state
    does not grow, and ``mamba2-1.3b`` decodes the JAX engine's greedy
    tokens; the hybrid's K/V cache of 8 slots refuses."""
    prompts = fx["prompts"][:, :10]
    teng = DecodeEngine(fx["tmodel"], fx["tparams"], max_len=8, device="cpu")
    if fx["tmodel"].cfg.family == "hybrid":
        with pytest.raises(ValueError, match="max_len is 8"):
            teng.generate(prompts, 5)
        return
    want = JEngine(fx["jmodel"], fx["jparams"], max_len=8).generate(
        prompts, 5).tokens
    _assert_decided(fx, prompts, want, screened=False)
    np.testing.assert_array_equal(teng.generate(prompts, 5).tokens,
                                  np.asarray(want))


@pytest.mark.parametrize("tname,jname,kw", [
    ("exact", "exact", {}),
    ("screened-cuda", "screened-pallas", {"fused": True}),
], ids=["exact", "cuda-fused"])
def test_bf16_cache_generate_and_beam_match_reference(fx, tname, jname, kw):
    """``cache_dtype=bfloat16``: conv tails and shared-attention K/V caches
    in bf16 (SSM states stay f32) on both engines."""
    jeng = JEngine(fx["jmodel"], fx["jparams"], screen=fx["jscreen"],
                   max_len=MAX_LEN, cache_dtype=jnp.bfloat16, head_kwargs=kw)
    teng = DecodeEngine(fx["tmodel"], fx["tparams"], screen=fx["tscreen"],
                        max_len=MAX_LEN, cache_dtype=torch.bfloat16,
                        head_kwargs=kw, device="cpu")
    want = jeng.generate(fx["prompts"], NEW, head=jname).tokens
    _assert_decided(fx, fx["prompts"], want, screened=tname != "exact",
                    cache_dtype=jnp.bfloat16)
    got = teng.generate(fx["prompts"], NEW, head=tname).tokens
    np.testing.assert_array_equal(got, np.asarray(want))

    jb = jeng.beam_search(fx["prompts"][0], 4, 6, head=jname)
    tb = teng.beam_search(fx["prompts"][0], 4, 6, head=tname)
    np.testing.assert_array_equal(tb.tokens, jb.tokens)
    np.testing.assert_allclose(tb.scores, jb.scores, rtol=0, atol=1e-4)
