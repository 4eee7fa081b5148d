"""Training the dense (``gemma-2b``, ``starcoder2-3b``) and moe
(``mixtral-8x7b``, ``phi3.5-moe-42b-a6.6b``) families on the port, against
the JAX package on the same seeded numpy inputs (reduced configs: 2 layers,
d = 128, ≤ 4 experts; weights initialised in JAX and carried by
``interop.params_from_numpy``), and the fast synthetic corpus:

  * ``loss_and_grads`` against ``jax.value_and_grad`` of the reference's
    ``train_loss`` (GeGLU and head_dim 256; layernorm, gelu and biases; the
    moe aux loss in the loss): loss within rtol 1e-6, every gradient leaf
    within 1e-4 of the largest |g|;
  * remat on against off bit for bit for moe, and the aux loss finite,
    positive and in the loss;
  * two ``make_train_step`` steps (donated) against the reference's jitted
    step: loss and gnorm within rtol 1e-4;
  * ``launch.train --reduced --device cpu`` for gemma-2b and mixtral, with
    a checkpoint and a resume, and a reference checkpoint of a reduced
    mixtral loading into the port's template;
  * ``ZipfMarkovCorpus``: ``succ``, ``probs`` and ``sample_batch``
    bit-identical to the reference's at V = 512 and 4,096 over several
    seeds, the exact retry rounds forced too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as j_save
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as j_get_config
from repro.data import ZipfMarkovCorpus as JCorpus
from repro.data import make_lm_batches as j_batches
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import build_model
from repro.models.lm import train_loss as j_train_loss
from repro.optim import adamw_init as j_adamw_init
from repro_torch.checkpoint import latest_step, load_checkpoint
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import ZipfMarkovCorpus
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import Model
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_flatten

ARCHS = ["gemma-2b", "starcoder2-3b", "mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]
B, T = 2, 24


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tbatch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """A reduced dense / moe LM initialised in JAX (float32), the same
    weights in the port, and two batches of the synthetic corpus."""
    jcfg = j_get_config(request.param).reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.key(5), dtype=jnp.float32)
    corpus = JCorpus(jcfg.vocab_size, branching=16, seed=0)
    return dict(name=request.param, jmodel=jmodel, jparams=jparams,
                tmodel=Model(get_config(request.param).reduced()),
                tparams=params_from_numpy(_np_tree(jparams)),
                batches=list(j_batches(corpus, 2, B, T, seed=4)))


def test_loss_and_grads_match_reference(lm):
    """Loss within rtol 1e-6 and every gradient leaf within 1e-4 of the
    largest |g| of ``jax.value_and_grad(train_loss)``."""
    b = lm["batches"][0]
    loss, grads = loss_and_grads(lm["tmodel"], TrainConfig(
        remat="none", loss_chunk=None), lm["tparams"], _tbatch(b))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: j_train_loss(
        lm["jmodel"], p, _jbatch(b))))(lm["jparams"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    want = jax.tree_util.tree_leaves(jg)
    got = tree_flatten(grads)
    scale = max(float(np.max(np.abs(np.asarray(g)))) for g in want)
    assert scale > 1e-3 and len(got) == len(want)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=1e-4 * scale)


def test_moe_remat_bit_identical_and_aux_in_the_loss():
    """Reduced mixtral: remat on and off give the same loss and gradients
    bit for bit; the aux loss is finite, positive, summed over the layers
    and part of the loss (the router's gradient moves with its weight)."""
    cfg = get_config("mixtral-8x7b").reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(3), device="cpu",
                        dtype=torch.float32)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, T + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {r: loss_and_grads(model, TrainConfig(remat=r, loss_chunk=None),
                             params, batch) for r in ("none", "block")}
    assert torch.equal(out["none"][0], out["block"][0])
    for a, c in zip(tree_flatten(out["none"][1]),
                    tree_flatten(out["block"][1])):
        assert torch.equal(a, c)
    h, aux = model.forward(params, batch)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert torch.isfinite(aux) and float(aux) > 0
    xent = torch.nn.functional.cross_entropy(
        model.logits(params, h).flatten(0, 1), batch["labels"].flatten())
    np.testing.assert_allclose(float(out["none"][0]), float(xent + aux),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["gemma-2b", "mixtral-8x7b"])
def test_two_train_steps_match_the_reference(name):
    """Two donated ``make_train_step`` steps (clip, cosine, AdamW) against
    the reference's jitted step: loss and gnorm within rtol 1e-4."""
    jcfg = j_get_config(name).reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.key(6), dtype=jnp.float32)
    batches = list(j_batches(JCorpus(jcfg.vocab_size, branching=16, seed=1),
                             2, B, T, seed=8))
    tcfg = dict(lr=2e-3, warmup_steps=1, total_steps=10, remat="none",
                loss_chunk=None)
    jstep = jax.jit(j_make_train_step(jmodel, JTrainConfig(**tcfg)))
    step = make_train_step(Model(get_config(name).reduced()),
                           TrainConfig(**tcfg), donate=True)
    jp, js = jparams, j_adamw_init(jparams)
    tp = params_from_numpy(_np_tree(jparams))
    ts = adamw_init(tp)
    for b in batches:
        jp, js, jm = jstep(jp, js, _jbatch(b))
        tp, ts, m = step(tp, ts, _tbatch(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]),
                                   rtol=1e-4)
    assert int(ts.step) == 2


@pytest.mark.parametrize("arch", ["gemma-2b", "mixtral-8x7b"])
def test_launch_train_dense_and_moe_checkpoint_and_resume(arch, tmp_path,
                                                          capsys):
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    assert train_cli.main(args + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("[train] step") == 2 and "saved checkpoint" in out
    assert "[train] corpus of 512 words built in" in out
    assert train_cli.main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and out.count("[train] step") == 1
    assert latest_step(str(tmp_path)) == 3


def test_reference_mixtral_checkpoint_loads_into_the_port_template(tmp_path):
    """(params, AdamW state) of reduced mixtral saved by the reference after
    one step load into the port's template leaf for leaf."""
    jcfg = j_get_config("mixtral-8x7b").reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.key(7), dtype=jnp.float32)
    b = next(iter(j_batches(JCorpus(jcfg.vocab_size, branching=16, seed=0),
                            1, B, T, seed=2)))
    jp, js, _ = jax.jit(j_make_train_step(jmodel, JTrainConfig(
        remat="none", loss_chunk=None)))(jparams, j_adamw_init(jparams),
                                         _jbatch(b))
    j_save(str(tmp_path), 1, (jp, js), {"step": 1})
    tparams = Model(get_config("mixtral-8x7b").reduced()).init(
        torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    (tp, ts), meta = load_checkpoint(str(tmp_path),
                                     (tparams, adamw_init(tparams)))
    assert meta == {} and int(ts.step) == 1
    for a, c in zip(tree_flatten((tp, ts)),
                    jax.tree_util.tree_leaves((jp, js))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


@pytest.mark.parametrize("V,seed,exact", [
    (512, 0, False), (512, 3, True), (4096, 1, False), (4096, 2, True)])
def test_fast_corpus_bit_identical_to_the_reference(V, seed, exact):
    """The fast construction (and, with ``exact``, its exact retry rounds
    alone) gives the reference's successor sets, probabilities and batches
    bit for bit."""
    br = min(64, V // 4)
    want = JCorpus(V, branching=br, seed=seed)
    got = ZipfMarkovCorpus(V, branching=br, seed=seed)
    if exact:
        got._build(exact=True)
    np.testing.assert_array_equal(got.succ, want.succ)
    np.testing.assert_array_equal(got.probs, want.probs)
    np.testing.assert_array_equal(got.sample_batch(3, 17, seed=5),
                                  want.sample_batch(3, 17, seed=5))
