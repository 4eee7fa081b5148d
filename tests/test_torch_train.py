"""The port's LM trainer against the JAX package's on the same seeded numpy
inputs: configs, schedules, clipping and AdamW (within 1e-6), the loss with
and without ``loss_chunk`` (1e-6), the train step's gradients on
``ptb-small-lstm`` reduced (1e-5 of the largest |g|) and its loss after 3
steps (1e-4 relative), the synthetic corpus (bit for bit), the batch loader,
checkpoints (the reference's ``arrays.npz`` loads into the port's template),
the params interop both ways, and ``python -m repro_torch.launch.train``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as j_save
from repro.configs import L2SConfig as JL2SConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as j_get_config
from repro.data import ZipfMarkovCorpus as JCorpus
from repro.data import make_lm_batches as j_batches
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import build_model
from repro.models.lm import cross_entropy_loss as j_xent
from repro.models.lm import train_loss as j_train_loss
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import cosine_schedule as j_cosine
from repro.optim import linear_warmup as j_warmup
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import L2SConfig, TrainConfig, get_config
from repro_torch.data import BatchLoader, ZipfMarkovCorpus, make_lm_batches
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import Model
from repro_torch.models.lm import cross_entropy_loss, train_loss
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               linear_warmup)
from repro_torch.tree import tree_flatten

ARCH = "ptb-small-lstm"
B, T = 4, 12


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def lm():
    """ptb-small-lstm reduced: JAX params and the same weights in the port,
    with a sharper head than the 0.02-scale init so the loss has real
    gradients, and a few batches of the synthetic corpus."""
    jcfg = j_get_config(ARCH).reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.key(3), dtype=jnp.float32)
    jparams["embed"]["lm_head"] = jparams["embed"]["lm_head"] * 50.0
    tparams = params_from_numpy(_np_tree(jparams))
    corpus = JCorpus(jcfg.vocab_size, branching=16, seed=0)
    batches = list(j_batches(corpus, 3, B, T, seed=5))
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams,
                tmodel=Model(get_config(ARCH).reduced()), tparams=tparams,
                batches=batches)


def _tbatch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# -- configs, optimiser ---------------------------------------------------------

@pytest.mark.parametrize("ours,ref", [(L2SConfig, JL2SConfig),
                                      (TrainConfig, JTrainConfig)])
def test_train_configs_match_the_reference(ours, ref):
    assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())


def test_schedules_match():
    for s in [0, 1, 5, 10, 11, 99, 100, 101, 550, 1000, 1200]:
        np.testing.assert_allclose(
            float(cosine_schedule(torch.tensor(s), 2e-3, 100, 1000)),
            float(j_cosine(jnp.asarray(s), 2e-3, 100, 1000)), rtol=1e-6)
        np.testing.assert_allclose(
            float(linear_warmup(torch.tensor(s), 1.0, 10)),
            float(j_warmup(jnp.asarray(s), 1.0, 10)), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches(max_norm):
    rng = np.random.default_rng(1)
    tree = {"b": rng.standard_normal((7,)).astype(np.float32),
            "a": [rng.standard_normal((3, 5)).astype(np.float32)]}
    got, gn = clip_by_global_norm(params_from_numpy(tree), max_norm)
    want, jgn = j_clip(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    for a, b in zip(tree_flatten(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_adamw_update_matches_on_identical_inputs():
    rng = np.random.default_rng(2)
    p = {"w": rng.standard_normal((6, 4)).astype(np.float32),
         "b": rng.standard_normal((4,)).astype(np.float32)}
    tp, jp = params_from_numpy(p), jax.tree_util.tree_map(jnp.asarray, p)
    ts, js = adamw_init(tp), j_adamw_init(jp)
    assert isinstance(ts, AdamWState) and int(ts.step) == 0
    for i in range(4):
        g = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
             for k, v in p.items()}
        lr = 1e-2 * (i + 1)
        tp, ts = adamw_update(params_from_numpy(g), ts, tp, torch.tensor(lr))
        jp, js = j_adamw_update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                jp, jnp.float32(lr))
        for name in p:
            for a, b in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
                np.testing.assert_allclose(a[name].numpy(),
                                           np.asarray(b[name]), rtol=1e-6,
                                           atol=1e-7)
    assert int(ts.step) == int(js.step) == 4


# -- losses and the train step ---------------------------------------------------

def test_cross_entropy_loss_matches():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = cross_entropy_loss(torch.as_tensor(logits),
                                 torch.as_tensor(labels),
                                 None if m is None else torch.as_tensor(m))
        want = j_xent(jnp.asarray(logits), jnp.asarray(labels),
                      None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("loss_chunk", [None, 4, 5, 1])
def test_train_loss_matches(lm, loss_chunk):
    """loss_chunk 5 does not divide T = 12 (gcd 1: the unchunked path), 4
    does; the chunked loss and its gradient equal the unchunked ones."""
    b = lm["batches"][0]
    got = train_loss(lm["tmodel"], lm["tparams"], _tbatch(b),
                     loss_chunk=loss_chunk)
    want = j_train_loss(lm["jmodel"], lm["jparams"], _jbatch(b),
                        loss_chunk=loss_chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if loss_chunk == 4:
        tc = TrainConfig(loss_chunk=4)
        l4, g4 = loss_and_grads(lm["tmodel"], tc, lm["tparams"], _tbatch(b))
        l0, g0 = loss_and_grads(lm["tmodel"], dataclasses.replace(
            tc, loss_chunk=None), lm["tparams"], _tbatch(b))
        np.testing.assert_allclose(float(l4), float(l0), rtol=1e-6)
        for a, c in zip(tree_flatten(g4), tree_flatten(g0)):
            torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("microbatch", [None, 2])
def test_train_step_gradients_match(lm, microbatch):
    """Gradients within 1e-5 of the largest |g| of the reference's."""
    b = lm["batches"][0]
    tcfg = TrainConfig(remat="none", loss_chunk=None, microbatch=microbatch)
    loss, grads = loss_and_grads(lm["tmodel"], tcfg, lm["tparams"], _tbatch(b))
    jl, jg = jax.value_and_grad(
        lambda p: j_train_loss(lm["jmodel"], p, _jbatch(b)))(lm["jparams"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    scale = max(float(jnp.max(jnp.abs(g))) for g in jleaves)
    assert scale > 1e-3
    for a, c in zip(tree_flatten(grads), jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=1e-5 * scale)


def test_train_step_loss_after_three_steps(lm):
    """Three full steps (clip, cosine schedule, AdamW) from the same params:
    the third step's loss within 1e-4 relative, gnorms within 1e-4."""
    tcfg = TrainConfig(lr=2e-3, warmup_steps=2, total_steps=10, remat="none",
                       loss_chunk=None)
    jcfg = JTrainConfig(lr=2e-3, warmup_steps=2, total_steps=10, remat="none",
                        loss_chunk=None)
    step = make_train_step(lm["tmodel"], tcfg)
    jstep = jax.jit(j_make_train_step(lm["jmodel"], jcfg))
    tp, ts = lm["tparams"], adamw_init(lm["tparams"])
    jp, js = lm["jparams"], j_adamw_init(lm["jparams"])
    for b in lm["batches"]:
        tp, ts, tm = step(tp, ts, _tbatch(b))
        jp, js, jm = jstep(jp, js, _jbatch(b))
        np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]),
                                   rtol=1e-4)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    assert int(ts.step) == 3


# -- data, loader, checkpoints, interop, CLI ----------------------------------------

def test_corpus_and_batches_bit_identical():
    ours, ref = ZipfMarkovCorpus(300, branching=16, seed=4), JCorpus(
        300, branching=16, seed=4)
    np.testing.assert_array_equal(ours.succ, ref.succ)
    np.testing.assert_array_equal(ours.probs, ref.probs)
    np.testing.assert_array_equal(ours.sample(50, seed=2),
                                  ref.sample(50, seed=2))
    for a, b in zip(make_lm_batches(ours, 3, 4, 16, seed=7),
                    j_batches(ref, 3, 4, 16, seed=7)):
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_batch_loader_moves_batches_to_the_device():
    batches = [{"tokens": np.arange(6, dtype=np.int32).reshape(2, 3)}]
    got = list(BatchLoader(iter(batches), device="cpu"))
    assert got[0]["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got[0]["tokens"].numpy(),
                                  batches[0]["tokens"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BatchLoader(iter(batches))


def test_params_interop_round_trip_bit_identical(lm):
    back = params_to_numpy(lm["tparams"])
    want = _np_tree(lm["jparams"])
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_checkpoint_round_trip(tmp_path, lm):
    tree = (lm["tparams"], adamw_init(lm["tparams"]))
    save_checkpoint(str(tmp_path), 7, tree, {"note": "x", "step": 7})
    save_checkpoint(str(tmp_path), 3, tree)
    assert latest_step(str(tmp_path)) == 7
    got, meta = load_checkpoint(str(tmp_path), tree)
    assert meta == {"note": "x", "step": 7}
    assert isinstance(got[1], AdamWState)
    for a, b in zip(tree_flatten(tree), tree_flatten(got)):
        assert torch.equal(a, b)
    wrong = dict(lm["tparams"], embed=dict(lm["tparams"]["embed"],
                                           lm_bias=torch.zeros(3)))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path), (wrong, tree[1]))
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(str(tmp_path), {"a": torch.ones(2)})
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), tree)


def test_reference_checkpoint_loads_into_the_port_template(tmp_path, lm):
    """(params, AdamW state) saved by the reference after one step load into
    the port's template leaf for leaf."""
    jcfg = JTrainConfig(remat="none", loss_chunk=None)
    jp, js, _ = jax.jit(j_make_train_step(lm["jmodel"], jcfg))(
        lm["jparams"], j_adamw_init(lm["jparams"]), _jbatch(lm["batches"][0]))
    j_save(str(tmp_path), 1, (jp, js), {"step": 1})
    template = (lm["tparams"], adamw_init(lm["tparams"]))
    (tp, ts), meta = load_checkpoint(str(tmp_path), template)
    assert meta == {}                  # the reference's metadata is msgpack
    assert int(ts.step) == 1
    for a, b in zip(tree_flatten((tp, ts)),
                    jax.tree_util.tree_leaves((jp, js))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_launch_train_runs_reduced_on_the_cpu(tmp_path, capsys):
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "8", "--log-every", "1",
            "--ckpt-dir", str(tmp_path)]
    assert train_cli.main(args) == 0
    out = capsys.readouterr().out
    assert out.count("[train] step") == 3 and "saved checkpoint" in out
    assert latest_step(str(tmp_path)) == 3
    assert train_cli.main(args[:-4] + ["--steps", "4", "--ckpt-dir",
                                       str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and out.count("[train] step") == 1
    # an arch that no registry holds is refused; every family trains
    # (tests/test_torch_train_dense.py, test_torch_vlm.py, test_torch_audio.py)
    with pytest.raises(KeyError, match="no-such-arch"):
        train_cli.main(["--arch", "no-such-arch", "--device", "cpu"])
