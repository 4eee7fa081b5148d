"""The port's vlm family (``qwen2-vl-2b``) against the JAX package's, on the
reduced config (2 layers, d = 128, V = 512, P = 8 patches on a 2 x 4 grid)
with the reference's weights carried across by ``params_from_numpy`` (the
tied embedding × 20, so greedy steps are decided by gaps far above float32
rounding), and the same seeded numpy tokens and patches on both sides:

  * the config field for field and its ``param_count`` (1,543,655,424);
  * ``mrope_positions`` integer-equal to the reference's for P in 0, 4, 6
    (a 2 x 3 grid), 8 and 256 (16 x 16, text from 16); ``apply_mrope``
    within 1e-6 in float32 at head_dim 32 and 128, and in bfloat16 within
    one bf16 rounding of the same float32 rotation;
  * ``forward`` over patches + text within 1e-5; ``prefill`` and 8
    ``decode_step``s through the ``exact`` head: tokens bit-identical,
    every hidden state within 1e-5, and the caches; the decode position
    jump (text at max(gh, gw) + i in the prompt, then P + T + j) pinned;
    per-row ``pos`` bit-identical to a scalar ``pos``;
  * both packages in bfloat16: hidden states within 5 % of max |h| and
    greedy tokens equal except rows that first differ after a step whose
    reference top-2 gap is below the 0.5 margin (``test_torch_bf16.py``'s
    rule);
  * ``loss_and_grads`` (the loss over the text only) against
    ``jax.value_and_grad(train_loss)``; the launcher's patches equal the
    reference launcher's arrays bit for bit;
  * ``DecodeEngine`` and ``launch.serve`` refuse the vlm and audio families
    before any work; every config of the reference's registry is in the
    port's;
  * the vlm leaves (``vision_proj`` among them) cross ``interop`` in bf16
    bit for bit, and a reference checkpoint loads into the port's template.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import heads as jheads
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import get_config as j_get_config
from repro.launch import train as j_train_cli
from repro.layers import rope as jrope
from repro.models.lm import train_loss as j_train_loss
from repro.models.model import Model as JModel
from repro.optim import adamw_init as j_adamw_init
from repro_torch import heads as theads
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import REGISTRY, TrainConfig, get_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import loss_and_grads
from repro_torch.layers import rope as trope
from repro_torch.models import Model
from repro_torch.optim import adamw_init
from repro_torch.serving import DecodeEngine
from repro_torch.tree import tree_flatten, tree_leaves

NAME = "qwen2-vl-2b"
B, T, NEW = 2, 12, 8
BF16_MARGIN = 0.5          # the bf16 gap margin of tests/test_torch_bf16.py
H_REL = 0.05               # bf16 hidden states: 5 % of max |h|


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(a):
    """A numpy array's values, or a bf16 array's or tensor's raw bits."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16).numpy().view(np.uint16)
                if a.dtype == torch.bfloat16 else a.numpy())
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _build(dtype="float32", seed=9):
    jcfg = replace(j_get_config(NAME).reduced(), dtype=dtype)
    tcfg = replace(get_config(NAME).reduced(), dtype=dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(seed))
    jp["embed"]["embedding"] = jp["embed"]["embedding"] * 20.0
    rng = np.random.default_rng(seed)
    P, d = jcfg.num_patch_tokens, jcfg.d_model
    return dict(jm=jm, jp=jp, tm=Model(tcfg),
                tp=params_from_numpy(_np_tree(jp)), P=P,
                tokens=rng.integers(0, jcfg.vocab_size, (B, T)).astype(
                    np.int32),
                patches=rng.standard_normal((B, P, d)).astype(np.float32))


@pytest.fixture(scope="module")
def fx():
    return _build()


def _jbatch(f):
    return {"tokens": jnp.asarray(f["tokens"]),
            "patches": jnp.asarray(f["patches"])}


def _tbatch(f):
    return {"tokens": torch.from_numpy(f["tokens"]),
            "patches": torch.from_numpy(f["patches"])}


def _j_greedy(f, cache_dtype):
    """The reference: prefill over patches + text, then NEW greedy decode
    steps through its exact head at pos = P + T + j. → (tokens (B, NEW +
    1), hidden states (B, NEW + 1, d): the prefill's last and each
    step's)."""
    jm, jp, P = f["jm"], f["jp"], f["P"]
    head = jheads.get("exact", W=jp["embed"]["embedding"],
                      b=jp["embed"]["lm_bias"])
    cache = jm.init_cache(B, P + T + NEW, dtype=cache_dtype)
    h, cache = jm.prefill(jp, _jbatch(f), cache)
    hs, toks = [h[:, -1]], [head.next(h[:, -1])]
    for j in range(NEW):
        h1, cache = jm.decode_step(jp, toks[-1], cache, P + T + j)
        hs.append(h1)
        toks.append(head.next(h1))
    return (np.stack([np.asarray(t) for t in toks], 1),
            jnp.stack(hs, axis=1), cache)


def _t_greedy(f, cache_dtype, feed=None, per_row=False):
    """The port's twin of ``_j_greedy`` (``feed``: decode these tokens
    instead of its own; ``per_row``: pos as a (B,) int32 tensor)."""
    tm, tp, P = f["tm"], f["tp"], f["P"]
    head = theads.get("exact", W=tp["embed"]["embedding"],
                      b=tp["embed"]["lm_bias"], device="cpu")
    cache = tm.init_cache(B, P + T + NEW, dtype=cache_dtype, device="cpu")
    h, cache = tm.prefill(tp, _tbatch(f), cache)
    hs, toks = [h[:, -1]], [head.next(h[:, -1])]
    for j in range(NEW):
        tok = toks[-1] if feed is None else torch.from_numpy(feed[:, j])
        pos = P + T + j
        if per_row:
            pos = torch.full((B,), pos, dtype=torch.int32)
        h1, cache = tm.decode_step(tp, tok, cache, pos)
        hs.append(h1)
        toks.append(head.next(h1))
    return torch.stack(toks, 1).numpy(), torch.stack(hs, 1), cache


def test_config_and_param_count():
    cfg, jcfg = get_config(NAME), j_get_config(NAME)
    assert cfg.param_count() == jcfg.param_count() == 1_543_655_424
    assert (cfg.num_patch_tokens, cfg.positional, cfg.q_per_kv,
            cfg.supports_decode) == (256, "mrope", 6, True)
    r = cfg.reduced()
    assert r.num_patch_tokens == jcfg.reduced().num_patch_tokens == 8
    Model(cfg)                                    # builds at full width


@pytest.mark.parametrize("P", [0, 4, 6, 8, 256])
def test_mrope_positions_integer_equal(P):
    got = trope.mrope_positions(3, P, 7, device="cpu")
    want = np.asarray(jrope.mrope_positions(3, P, 7))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if P == 6:                                    # a 2 x 3 grid, text from 3
        assert got[0, :P, 1].max() == 1 and got[0, :P, 2].max() == 2
        assert got[0, P, 0] == 3
    if P == 256:                                  # 16 x 16, text from 16
        assert got[0, P].tolist() == [16, 16, 16]


@pytest.mark.parametrize("hd,dtype", [(32, "float32"), (128, "float32"),
                                      (128, "bfloat16")])
def test_apply_mrope_matches_reference(hd, dtype):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 20, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 20, 3)).astype(np.int32)
    if dtype == "bfloat16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).bfloat16()
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jrope.apply_mrope(jx, jnp.asarray(pos)), np.float32)
    got = trope.apply_mrope(tx, torch.from_numpy(pos))
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    # sections at half = 64: temporal 32, height 16, width 16
    assert trope.mrope_sections(64).bincount().tolist() == [32, 16, 16]


def test_forward_matches_reference(fx):
    jh, _ = fx["jm"].forward(fx["jp"], _jbatch(fx))
    th, aux = fx["tm"].forward(fx["tp"], _tbatch(fx))
    assert th.shape == (B, fx["P"] + T, 128) and aux == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)


def test_prefill_and_decode_match_reference(fx):
    """Greedy tokens bit-identical, hidden states within 1e-5, caches too."""
    want, jhs, jcache = _j_greedy(fx, jnp.float32)
    got, ths, tcache = _t_greedy(fx, torch.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(ths.numpy(), np.asarray(jhs), rtol=0,
                               atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache["attn"][k].numpy(),
                                   np.asarray(jcache["attn"][k]), rtol=0,
                                   atol=1e-5)


def test_decode_position_jump_is_the_references(fx):
    """The prompt's text sits at positions max(gh, gw) + i (4 + i on the
    2 x 4 grid), decode at P + T + j: the first decoded token's hidden
    state differs from a forward over the longer sequence (which puts it at
    4 + T) and equals the reference's decode at P + T."""
    P, tm, tp = fx["P"], fx["tm"], fx["tp"]
    pos = trope.mrope_positions(1, P, T)[0]
    assert pos[P].tolist() == [4] * 3 and pos[-1].tolist() == [4 + T - 1] * 3
    want, jhs, _ = _j_greedy(fx, jnp.float32)
    _, ths, _ = _t_greedy(fx, torch.float32)
    longer = dict(_tbatch(fx))
    longer["tokens"] = torch.cat([longer["tokens"],
                                  torch.from_numpy(want[:, :1])], dim=1)
    fh, _ = tm.forward(tp, longer)
    assert not np.allclose(fh[:, -1].numpy(), ths[:, 1].numpy(), atol=1e-3)
    np.testing.assert_allclose(ths[:, 1].numpy(), np.asarray(jhs[:, 1]),
                               rtol=0, atol=1e-5)


def test_per_row_pos_bit_identical_to_scalar(fx):
    a_tok, a_h, a_c = _t_greedy(fx, torch.float32)
    b_tok, b_h, b_c = _t_greedy(fx, torch.float32, per_row=True)
    np.testing.assert_array_equal(a_tok, b_tok)
    assert torch.equal(a_h, b_h)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(a_c),
                                                 tree_leaves(b_c)))


def test_bf16_matches_reference():
    """bf16 weights and caches on both sides; the reference's bf16 leaves
    arrive bit for bit; the port's prefill and decode fed the reference's
    tokens stay within 5 % of max |h|; its own greedy tokens equal the
    reference's except after a near tie (gap < 0.5)."""
    f = _build("bfloat16", seed=10)
    for a, t in zip(jax.tree_util.tree_leaves(_np_tree(f["jp"])),
                    tree_leaves(f["tp"])):
        np.testing.assert_array_equal(_bits(t), _bits(a))
    want, jhs, _ = _j_greedy(f, jnp.bfloat16)
    _, ths, _ = _t_greedy(f, torch.bfloat16, feed=want)
    assert ths.dtype == torch.bfloat16
    j = np.asarray(jhs, np.float32)
    assert np.abs(ths.float().numpy() - j).max() <= H_REL * np.abs(j).max()
    got, _, _ = _t_greedy(f, torch.bfloat16)
    logits = np.asarray(f["jm"].logits(f["jp"], jhs), np.float32)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gaps = top2[..., 1] - top2[..., 0]
    for i in range(B):
        bad = np.nonzero(got[i] != want[i])[0]
        if bad.size:
            assert gaps[i, bad[0]] < BF16_MARGIN, (i, bad[0], gaps[i, bad[0]])


def test_loss_and_grads_match_reference(fx):
    """The loss over the text region within rtol 1e-6, every gradient leaf
    (``vision_proj`` among them) within 1e-4 of the largest |g|."""
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 512, (B, T)).astype(np.int32)
    tb = dict(_tbatch(fx), labels=torch.from_numpy(labels))
    jb = dict(_jbatch(fx), labels=jnp.asarray(labels))
    loss, grads = loss_and_grads(fx["tm"], TrainConfig(
        remat="none", loss_chunk=None), fx["tp"], tb)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: j_train_loss(
        fx["jm"], p, jb)))(fx["jp"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    want = jax.tree_util.tree_leaves(jg)
    got = tree_flatten(grads)
    scale = max(float(np.max(np.abs(np.asarray(g)))) for g in want)
    assert scale > 1e-3 and len(got) == len(want)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=1e-4 * scale)
    assert float(grads["vision_proj"].abs().max()) > 0


def _launcher_batches(monkeypatch, module, argv, jax_side):
    """Run a training launcher with its step replaced by one that records
    each batch as numpy arrays (and ``jax.jit`` by the identity on the
    reference's side). → the batches."""
    seen = []

    def fake_make_train_step(*a, **k):
        def step(params, opt_state, batch):
            seen.append({n: np.asarray(v.cpu() if isinstance(
                v, torch.Tensor) else v) for n, v in batch.items()})
            return params, opt_state, {"loss": 0.0, "gnorm": 0.0}
        return step
    monkeypatch.setattr(module, "make_train_step", fake_make_train_step)
    if jax_side:
        monkeypatch.setattr(module.jax, "jit", lambda f: f)
    assert module.main(argv) == 0
    return seen


@pytest.mark.parametrize("arch", [NAME, "hubert-xlarge"])
def test_launcher_batches_equal_the_references(monkeypatch, capsys, arch):
    """The port's ``launch.train`` feeds its step the reference launcher's
    arrays bit for bit: patches (B, P, d) or frames (B, seq, d) float32
    and the labels (mod 504 for audio), over 3 steps; then it trains."""
    argv = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "8", "--log-every", "1", "--seed", "4"]
    with monkeypatch.context() as m:
        want = _launcher_batches(m, j_train_cli, argv, True)
    with monkeypatch.context() as m:
        got = _launcher_batches(m, train_cli, argv + ["--device", "cpu"],
                                False)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])
    capsys.readouterr()
    assert train_cli.main(argv[:3] + ["--steps", "2", "--batch", "2",
                                      "--seq", "8", "--log-every", "1",
                                      "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("[train] step") == 2


@pytest.mark.parametrize("arch", [NAME, "hubert-xlarge"])
def test_engine_and_serve_refuse(arch, capsys):
    """``launch.serve`` exits 2 before it trains; ``DecodeEngine`` raises
    at its prefill, before a cache exists."""
    assert serve_cli.main(["--arch", arch, "--reduced", "--device",
                           "cpu"]) == 2
    out = capsys.readouterr().out
    assert "DecodeEngine" in out and "[serve] trained" not in out
    cfg = get_config(arch).reduced()
    m = Model(cfg)
    eng = DecodeEngine(m, m.init(torch.Generator().manual_seed(0),
                                 device="cpu", dtype=torch.float32),
                       max_len=32, device="cpu")
    with pytest.raises(ValueError, match=cfg.family):
        eng.generate(np.zeros((1, 4), np.int32), 2)
    assert not eng._slabs


def test_every_reference_config_is_ported():
    assert set(J_REGISTRY) <= set(REGISTRY)
    for name in J_REGISTRY:
        assert get_config(name).param_count() == \
            j_get_config(name).param_count(), name


def test_interop_bf16_and_a_reference_checkpoint(tmp_path):
    """The reference's bf16 vlm leaves cross to the port and back bit for
    bit (``vision_proj`` included, leaf for leaf in the reference's order);
    a reference checkpoint of (params, AdamW state) loads into the port's
    template."""
    f = _build("bfloat16", seed=11)
    ref = jax.tree_util.tree_leaves(_np_tree(f["jp"]))
    assert len(ref) == len(tree_flatten(f["tp"]))
    assert f["tp"]["vision_proj"].dtype == torch.bfloat16
    for a, t in zip(ref, tree_flatten(f["tp"])):
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(_bits(t), _bits(a))
    back = jax.tree_util.tree_leaves(params_to_numpy(f["tp"],
                                                     bf16=ml_dtypes.bfloat16))
    for a, c in zip(ref, back):
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(_bits(c), _bits(a))
    jm = JModel(j_get_config(NAME).reduced())
    jp = jm.init(jax.random.key(12), dtype=jnp.float32)
    j_save(str(tmp_path), 1, (jp, j_adamw_init(jp)), {"step": 1})
    tm = Model(get_config(NAME).reduced())
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu",
                 dtype=torch.float32)
    (lp, _), _ = load_checkpoint(str(tmp_path), (tp, adamw_init(tp)))
    for a, c in zip(tree_flatten(lp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
