"""The port's audio family (``hubert-xlarge``, a bidirectional encoder over
stub frame embeddings) against the JAX package's, on the reduced config (2
layers, d = 128, 4 heads, layernorm, gelu, an untied 504-unit head,
sinusoidal positions) with the reference's weights carried across by
``params_from_numpy`` and the same seeded numpy frames on both sides:

  * the config field for field, its ``param_count`` (945,131,520), the
    model built at full width;
  * ``forward`` within 1e-5 in float32; with bf16 weights and float32
    frames the hidden states are float32 (JAX's promotion, which the port
    keeps: the frames are not cast to bf16) and match the reference's
    within 1e-5;
  * bidirectional: perturbing the last frame moves position 0; at T =
    2,048 the chunked attention path, non-causal, matches the reference
    within 1e-4 and the port's own unchunked path within 1e-5 relative;
  * ``init_cache`` raises ValueError (encoder-only), as the reference's;
  * ``loss_and_grads`` (masked-prediction labels; the unused token
    embedding's gradient is zero) against ``jax.value_and_grad``;
  * the audio leaves (``frame_proj``, the untied ``lm_head``) cross
    ``interop`` in bf16 bit for bit, and a reference checkpoint loads into
    the port's template.

The launcher's frames against the reference launcher's, and the serving
refusals, are in ``tests/test_torch_vlm.py`` (parametrised over both
families).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_config as j_get_config
from repro.models.lm import train_loss as j_train_loss
from repro.models.model import Model as JModel
from repro.optim import adamw_init as j_adamw_init
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import TrainConfig, get_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch.steps import loss_and_grads
from repro_torch.layers import attention as tattn
from repro_torch.models import Model
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_flatten

NAME = "hubert-xlarge"
B, T = 2, 24


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(a):
    """A numpy array's values, or a bf16 array's or tensor's raw bits."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16).numpy().view(np.uint16)
                if a.dtype == torch.bfloat16 else a.numpy())
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _build(dtype="float32", seed=13):
    jcfg = replace(j_get_config(NAME).reduced(), dtype=dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(seed))
    return dict(jm=jm, jp=jp,
                tm=Model(replace(get_config(NAME).reduced(), dtype=dtype)),
                tp=params_from_numpy(_np_tree(jp)))


@pytest.fixture(scope="module")
def fx():
    return _build()


def _frames(n, seed=1, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, n, 128)).astype(np.float32)


def _forward(f, frames):
    jh, jaux = f["jm"].forward(f["jp"], {"frames": jnp.asarray(frames)})
    th, aux = f["tm"].forward(f["tp"], {"frames": torch.from_numpy(frames)})
    return th, np.asarray(jh)


def test_config_and_param_count():
    cfg, jcfg = get_config(NAME), j_get_config(NAME)
    assert cfg.param_count() == jcfg.param_count() == 945_131_520
    assert (cfg.is_encoder, cfg.supports_decode, cfg.positional,
            cfg.num_patch_tokens) == (True, False, "learned", 0)
    Model(cfg)                                    # builds at full width


def test_forward_matches_reference(fx):
    th, jh = _forward(fx, _frames(T))
    assert th.dtype == torch.float32 and th.shape == (B, T, 128)
    np.testing.assert_allclose(th.numpy(), jh, rtol=0, atol=1e-5)


def test_bf16_weights_float32_frames_give_float32():
    """The reference promotes float32 frames against its bf16 frame_proj
    to float32 and runs the whole stack in float32 activations against
    bf16 weights; the port does the same, bit for bit on the weights."""
    f = _build("bfloat16", seed=14)
    assert f["tp"]["frame_proj"].dtype == torch.bfloat16
    th, jh = _forward(f, _frames(T, seed=2))
    assert jh.dtype == np.float32 and th.dtype == torch.float32
    np.testing.assert_allclose(th.numpy(), jh, rtol=0, atol=1e-5)
    logits = f["tm"].logits(f["tp"], th)
    assert logits.dtype == torch.float32 and logits.shape == (B, T, 504)


def test_bidirectional(fx):
    """Perturbing the last frame moves the hidden state at position 0."""
    frames = _frames(T, seed=3)
    h0, _ = fx["tm"].forward(fx["tp"], {"frames": torch.from_numpy(frames)})
    frames[:, -1] += 1.0
    h1, _ = fx["tm"].forward(fx["tp"], {"frames": torch.from_numpy(frames)})
    assert float((h1[:, 0] - h0[:, 0]).abs().max()) > 1e-3


def test_chunked_attention_is_non_causal(fx, monkeypatch):
    """T = 2,048 takes ``_sdpa_chunked``: against the reference's forward
    (its own chunked path) within 1e-4, and against the port's unchunked
    ``_sdpa`` (threshold raised) within 1e-5 relative."""
    frames = _frames(tattn.CHUNKED_ATTN_THRESHOLD, seed=4, batch=1)
    th, jh = _forward(fx, frames)
    np.testing.assert_allclose(th.numpy(), jh, rtol=0, atol=1e-4)
    monkeypatch.setattr(tattn, "CHUNKED_ATTN_THRESHOLD", 1 << 30)
    full, _ = fx["tm"].forward(fx["tp"], {"frames": torch.from_numpy(frames)})
    rel = float((th - full).abs().max() / full.abs().max())
    assert rel <= 1e-5, rel


def test_init_cache_raises(fx):
    with pytest.raises(ValueError, match="encoder-only"):
        fx["jm"].init_cache(1, 8)
    with pytest.raises(ValueError, match="encoder-only"):
        fx["tm"].init_cache(1, 8, device="cpu")


def test_loss_and_grads_match_reference(fx):
    """Loss within rtol 1e-6, every leaf within 1e-4 of the largest |g|;
    the token embedding, which the encoder never reads, gets zeros on both
    sides."""
    frames = _frames(T, seed=5)
    labels = np.random.default_rng(5).integers(0, 504, (B, T)).astype(
        np.int32)
    loss, grads = loss_and_grads(fx["tm"], TrainConfig(
        remat="none", loss_chunk=None), fx["tp"],
        {"frames": torch.from_numpy(frames),
         "labels": torch.from_numpy(labels)})
    jl, jg = jax.jit(jax.value_and_grad(lambda p: j_train_loss(
        fx["jm"], p, {"frames": jnp.asarray(frames),
                      "labels": jnp.asarray(labels)})))(fx["jp"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    want = jax.tree_util.tree_leaves(jg)
    got = tree_flatten(grads)
    scale = max(float(np.max(np.abs(np.asarray(g)))) for g in want)
    assert scale > 1e-3 and len(got) == len(want)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=1e-4 * scale)
    assert not grads["embed"]["embedding"].any()
    assert float(grads["frame_proj"].abs().max()) > 0


def test_interop_bf16_and_a_reference_checkpoint(tmp_path):
    f = _build("bfloat16", seed=15)
    ref = jax.tree_util.tree_leaves(_np_tree(f["jp"]))
    assert len(ref) == len(tree_flatten(f["tp"]))
    for a, t in zip(ref, tree_flatten(f["tp"])):
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(_bits(t), _bits(a))
    back = jax.tree_util.tree_leaves(params_to_numpy(f["tp"],
                                                     bf16=ml_dtypes.bfloat16))
    for a, c in zip(ref, back):
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(_bits(c), _bits(a))
    jm = JModel(j_get_config(NAME).reduced())
    jp = jm.init(jax.random.key(16), dtype=jnp.float32)
    j_save(str(tmp_path), 1, (jp, j_adamw_init(jp)), {"step": 1})
    tm = Model(get_config(NAME).reduced())
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu",
                 dtype=torch.float32)
    assert sorted(tp) == ["embed", "frame_proj", "stack"]
    (lp, _), _ = load_checkpoint(str(tmp_path), (tp, adamw_init(tp)))
    for a, c in zip(tree_flatten(lp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
