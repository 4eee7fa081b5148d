"""The port's LSTM model and decode engine against the JAX package's, on
weights initialised in JAX and carried across with ``params_from_numpy``.

Model: ``nmt-deen-lstm`` reduced (d = 128, V = 512) and a copy with V = 600,
whose last 128-row block is padded, so the padding path is on the decode
path. Hidden states of ``forward``, ``prefill`` (one-shot and resumed over a
split prompt) and ``decode_step`` agree within atol = 1e-5.

Slice end to end, ``DecodeEngine(device="cpu")``: greedy ``generate``
through ``exact`` and ``screened-cuda`` (fused and unfused) gives the tokens
of the JAX engine through ``exact`` and ``screened-pallas``, and
``beam_search`` (beam 4) the same top beam with its score within 1e-5. The
fixture asserts that every decided step has a top-2 gap above 1e-4 (logits,
and cluster scores on the screened path), so the equality is meaningful.
``ptb-small-lstm`` decodes past ``max_len`` with the reference's tokens.
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
from repro.models.model import Model as JModel
from repro.serving.engine import DecodeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, screen_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.serving import DecodeEngine

V_BLK = 128
GAP = 1e-4
B, TP, NEW = 3, 5, 8


def _build(vocab):
    jcfg = replace(j_get_config("nmt-deen-lstm").reduced(), vocab_size=vocab)
    tcfg = replace(get_config("nmt-deen-lstm").reduced(), vocab_size=vocab)
    assert (tcfg.d_model, tcfg.num_layers) == (jcfg.d_model, jcfg.num_layers)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(vocab))
    # sharper logits than the 0.02-scale init, so greedy steps are decided
    # by gaps far above float32 rounding (asserted below)
    jparams["embed"]["lm_head"] = jparams["embed"]["lm_head"] * 100.0
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(vocab)
    r, d = 4, jcfg.d_model
    n_blk = -(-vocab // V_BLK)
    mask = np.zeros((r, n_blk), bool)
    mask[0, [0, n_blk - 1]] = True                # padded last block
    mask[1, 1:3] = True
    mask[2, :] = True
    mask[3, [1, n_blk - 1]] = True
    idx, lens = candidates_to_padded(mask, vocab, block=V_BLK)
    v = (rng.standard_normal((r, d)) * 3).astype(np.float32)
    jscreen = JScreen(v=jnp.asarray(v), cand_idx=jnp.asarray(idx),
                      cand_len=jnp.asarray(lens), vocab_size=vocab,
                      block=V_BLK)
    tscreen = screen_from_numpy(v, idx, lens, vocab, V_BLK)
    word_mask = np.repeat(mask, V_BLK, axis=1)[:, :vocab]
    return dict(vocab=vocab, jmodel=jmodel, jparams=jparams,
                tmodel=Model(tcfg), tparams=params_from_numpy(tree),
                jscreen=jscreen, tscreen=tscreen, v=v, word_mask=word_mask,
                prompts=rng.integers(0, vocab, (B, TP)).astype(np.int32))


@pytest.fixture(scope="module", params=[512, 600], ids=["V512", "V600"])
def fx(request):
    return _build(request.param)


def _top2_gap(x):
    s = np.sort(np.asarray(x, np.float64), axis=-1)
    return s[..., -1] - s[..., -2]


def _assert_decided(fx, prompts, tokens, screened):
    """Every step of the path the reference took is decided by a margin:
    top-2 logit gap (within the routed candidates on the screened path)
    and, when screened, top-2 cluster-score gap."""
    seq = np.concatenate([prompts, tokens[:, :-1]], axis=1)
    h, _ = fx["jmodel"].forward(fx["jparams"], {"tokens": jnp.asarray(seq)})
    h = np.asarray(h)[:, prompts.shape[1] - 1:]              # (B, NEW, d)
    logits = np.asarray(fx["jmodel"].logits(fx["jparams"], jnp.asarray(h)))
    if screened:
        scores = h @ fx["v"].T
        assert _top2_gap(scores).min() > GAP
        allowed = fx["word_mask"][scores.argmax(-1)]
        logits = np.where(allowed, logits, -np.inf)
    assert _top2_gap(logits).min() > GAP


def test_model_hidden_states_match(fx):
    jm, jp, tm, tp = fx["jmodel"], fx["jparams"], fx["tmodel"], fx["tparams"]
    toks = fx["prompts"]
    jh, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    th, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)

    jcache = jm.init_cache(B, 32, dtype=jnp.float32)
    jh, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcache)
    tcache = tm.init_cache(B, dtype=torch.float32, device="cpu")
    th1, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :2])},
                             tcache)
    th2, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, 2:])},
                             tcache, resume=True)
    np.testing.assert_allclose(torch.cat([th1, th2], 1).numpy(),
                               np.asarray(jh), atol=1e-5)
    tok = toks[:, -1]
    for i in range(3):
        jh1, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache, TP + i)
        th1, tcache = tm.decode_step(tp, torch.from_numpy(tok), tcache, TP + i)
        np.testing.assert_allclose(th1.numpy(), np.asarray(jh1), atol=1e-5)
        for jl, tl in zip(jcache["lstm"], tcache["lstm"]):
            np.testing.assert_allclose(tl["c"].numpy(), np.asarray(jl["c"]),
                                       atol=1e-5)
        tok = (tok * 7 + i) % fx["vocab"]
    W, b = tm.softmax_weights(tp)
    assert tuple(W.shape) == (fx["vocab"], 128) and tuple(b.shape) == (fx["vocab"],)


@pytest.mark.parametrize("tname,jname,kw", [
    ("exact", "exact", {}),
    ("screened-cuda", "screened-pallas", {"fused": True}),
    ("screened-cuda", "screened-pallas", {"fused": False}),
], ids=["exact", "cuda-fused", "cuda-unfused"])
def test_greedy_generate_and_beam_match_reference(fx, tname, jname, kw):
    jeng = JEngine(fx["jmodel"], fx["jparams"], screen=fx["jscreen"],
                   max_len=32, head_kwargs=kw)
    teng = DecodeEngine(fx["tmodel"], fx["tparams"], screen=fx["tscreen"],
                        head_kwargs=kw, device="cpu")
    want = jeng.generate(fx["prompts"], NEW, head=jname).tokens
    _assert_decided(fx, fx["prompts"], want, screened=tname != "exact")
    got = teng.generate(fx["prompts"], NEW, head=tname).tokens
    np.testing.assert_array_equal(got, np.asarray(want))

    jb = jeng.beam_search(fx["prompts"][0], 4, 6, head=jname)
    tb = teng.beam_search(fx["prompts"][0], 4, 6, head=tname)
    np.testing.assert_array_equal(tb.tokens, jb.tokens)
    np.testing.assert_allclose(tb.scores, jb.scores, rtol=0, atol=1e-5)
    assert not any(ops.LAUNCHES.values())          # no kernel on the CPU


def test_lstm_decodes_past_max_len_like_the_reference():
    """The LSTM state does not grow with the sequence: ``ptb-small-lstm``
    decodes a prompt of 10 tokens and 5 new ones with max_len = 8, with the
    JAX engine's greedy tokens (each step decided by a top-2 gap > 1e-4)."""
    jcfg = j_get_config("ptb-small-lstm").reduced()
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(3))
    jparams["embed"]["lm_head"] = jparams["embed"]["lm_head"] * 100.0
    tmodel = Model(get_config("ptb-small-lstm").reduced())
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    want = JEngine(jmodel, jparams, max_len=8).generate(prompts, 5).tokens
    seq = np.concatenate([prompts, np.asarray(want)[:, :-1]], axis=1)
    h, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(seq)})
    logits = jmodel.logits(jparams, h[:, prompts.shape[1] - 1:])
    assert _top2_gap(logits).min() > GAP
    got = DecodeEngine(tmodel, tparams, max_len=8,
                       device="cpu").generate(prompts, 5).tokens
    np.testing.assert_array_equal(got, np.asarray(want))


def test_sampled_generate_runs_in_vocab(fx):
    """Sampling (no reference parity: the two frameworks' generators
    differ) is seeded, repeatable, and stays in the vocabulary."""
    teng = DecodeEngine(fx["tmodel"], fx["tparams"], screen=fx["tscreen"],
                        device="cpu")
    for top_p in (1.0, 0.9):
        a = teng.generate(fx["prompts"], 4, head="screened-cuda",
                          temperature=1.0, top_p=top_p, seed=7).tokens
        b = teng.generate(fx["prompts"], 4, head="screened-cuda",
                          temperature=1.0, top_p=top_p, seed=7).tokens
        np.testing.assert_array_equal(a, b)
        assert a.shape == (B, 4) and a.min() >= 0 and a.max() < fx["vocab"]
    with pytest.raises(ValueError, match="seed"):
        teng.generate(fx["prompts"], 2, temperature=1.0)
