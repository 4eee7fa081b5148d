"""Models shared by the port's scheduler, resilience and observe tests
(``tests/test_torch_{scheduler,resilience,observe}.py``): the same weights
in both packages, initialised in JAX and carried across with
``params_from_numpy``, and a 128-word block screen in both.

  * ``lstm_fx``: ``nmt-deen-lstm`` reduced (d = 128, V = 512), ``lm_head``
    × 100 (the fixture of ``tests/test_torch_serving.py``);
  * ``hybrid_fx``: ``zamba2-2.7b`` reduced (d = 128, chunk 16), the
    embedding × 20 (the fixture of ``tests/test_torch_hybrid.py``).

``assert_decided`` holds the CPU comparison rule: every step of the
reference's greedy decode is decided by a top-2 gap above ``GAP`` (within
the routed candidates, and between cluster scores, on a screened head).
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as j_get_config
from repro.core.screening import ScreenParams as JScreen
from repro.core.screening import candidates_to_padded
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, screen_from_numpy
from repro_torch.models import Model

V_BLK = 128
GAP = 1e-4
# the port's name for the reference's kernel head
TWIN = {"screened-cuda": "screened-pallas"}
UNTWIN = {v: k for k, v in TWIN.items()}


def _build(name, seed, scale_leaf, scale):
    jcfg = j_get_config(name).reduced()
    vocab, d = jcfg.vocab_size, jcfg.d_model
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    jparams["embed"][scale_leaf] = jparams["embed"][scale_leaf] * scale
    rng = np.random.default_rng(seed)
    r, n_blk = 4, vocab // V_BLK
    mask = np.zeros((r, n_blk), bool)
    mask[0, [0, 3]] = True
    mask[1, 1:3] = True
    mask[2, :] = True
    mask[3, [1, 3]] = True
    idx, lens = candidates_to_padded(mask, vocab, block=V_BLK)
    v = (rng.standard_normal((r, d)) * 3).astype(np.float32)
    return dict(
        vocab=vocab, jmodel=jmodel, jparams=jparams,
        tmodel=Model(get_config(name).reduced()),
        tparams=params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams)),
        v=v, word_mask=np.repeat(mask, V_BLK, axis=1)[:, :vocab],
        jscreen=JScreen(v=jnp.asarray(v), cand_idx=jnp.asarray(idx),
                        cand_len=jnp.asarray(lens), vocab_size=vocab,
                        block=V_BLK),
        tscreen=screen_from_numpy(v, idx, lens, vocab, V_BLK))


def lstm_fx():
    return _build("nmt-deen-lstm", 11, "lm_head", 100.0)


def hybrid_fx():
    return _build("zamba2-2.7b", 7, "embedding", 20.0)


def prompts(fx, n, length, seed):
    return np.random.default_rng(seed).integers(
        0, fx["vocab"], (n, length)).astype(np.int32)


def _top2_gap(x):
    s = np.sort(np.asarray(x, np.float64), axis=-1)
    return s[..., -1] - s[..., -2]


def assert_decided(fx, prompt, tokens, screened):
    """Every step of the reference's greedy decode of ``prompt`` (1-D) into
    ``tokens`` is decided by a top-2 gap above GAP."""
    seq = np.concatenate([prompt, tokens[:-1]])[None]
    h, _ = fx["jmodel"].forward(fx["jparams"], {"tokens": jnp.asarray(seq)})
    h = np.asarray(h)[0, len(prompt) - 1:]
    logits = np.asarray(fx["jmodel"].logits(fx["jparams"], jnp.asarray(h)))
    if screened:
        scores = h @ fx["v"].T
        assert _top2_gap(scores).min() > GAP
        logits = np.where(fx["word_mask"][scores.argmax(-1)], logits, -np.inf)
    assert _top2_gap(logits).min() > GAP


def outcome(r, head_map=None):
    """A result reduced to what both packages must agree on: its type, the
    head (the reference's name for the port's kernel head), the tokens, and
    for an ``AdmissionRejected`` its stage."""
    head = r.head if head_map is None else head_map.get(r.head, r.head)
    tokens = None if r.tokens is None else [int(t) for t in r.tokens]
    return (type(r).__name__, head, tokens, getattr(r, "stage", None))
