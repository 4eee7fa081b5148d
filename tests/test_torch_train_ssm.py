"""Training the ``ssm`` (mamba2-1.3b) and ``hybrid`` (zamba2-2.7b) families
on the port, against the JAX package on the same seeded numpy inputs
(weights initialised in JAX and carried by ``interop.params_from_numpy``):

  * ``ssd_intra_bwd_plain`` (the closed-form gradient the backward kernel
    computes) against ``jax.vjp`` of ``repro.kernels.ssd.ssd_intra_ref`` and
    against torch autograd of ``ssd_intra_plain``, G = 1 and 2: 1e-5 of each
    gradient's largest magnitude;
  * ``layers/ssm.py::ssd_chunked``'s gradients in x, B, C, dt, A_log and D
    against ``jax.grad`` of the reference's, with a padded T: 1e-4 of max;
  * ``loss_and_grads`` of reduced mamba2 and zamba2 against
    ``jax.value_and_grad(repro.models.lm.train_loss)``, remat off and on:
    loss rtol 1e-4, every leaf within 1e-4 of the largest |g|; remat on
    and off bit-identical on the CPU;
  * three ``make_train_step`` steps of reduced zamba2 (functional and
    donated) against the reference's jitted step: loss and gnorm rtol 1e-4;
    the donated, sliced AdamW update bit-identical to the functional one;
  * checkpoints of the stacked trees with AdamW state (round trip, and the
    reference's loading into the port's template); ``launch.train`` with a
    checkpoint and a resume, and ``launch.serve`` on both families.

  * the backward kernel's split TF32 (3xTF32) emulated in every product of
    the closed form, at Q = 256, against ``jax.vjp``: 1e-4 of max, the
    kernel's own tolerance, with the one-product (1xTF32) error beside it.

tests/test_torch_cuda.py holds the backward kernel against
``ssd_intra_bwd_plain`` on the card.
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
from repro.kernels.ssd import ssd_intra_ref
from repro.launch.steps import make_train_step as j_make_train_step
from repro.layers import ssm as jssm
from repro.models import build_model
from repro.models.lm import train_loss as j_train_loss
from repro.optim import adamw_init as j_adamw_init
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import TrainConfig, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.ssd import (ssd_intra, ssd_intra_bwd_plain,
                                     ssd_intra_plain)
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.layers import ssm as tssm
from repro_torch.models import Model
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm)
from repro_torch.optim import adamw as adamw_mod
from repro_torch.tree import tree_flatten

ARCHS = ["mamba2-1.3b", "zamba2-2.7b"]
B, T = 2, 40                      # reduced chunk 16: T = 40 pads the last chunk


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_abs(leaves):
    return max(float(np.max(np.abs(np.asarray(g)))) for g in leaves)


def _assert_leaves_close(got, want, tol):
    """Every leaf of ``got`` within ``tol`` x the largest |g| of ``want``."""
    scale = _max_abs(want)
    assert scale > 1e-3
    assert len(got) == len(want)
    for a, c in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c), rtol=0,
                                   atol=tol * scale)


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """A reduced SSM / hybrid LM initialised in JAX (float32), the same
    weights in the port, and three batches of the synthetic corpus."""
    jcfg = j_get_config(request.param).reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.key(5), dtype=jnp.float32)
    corpus = JCorpus(jcfg.vocab_size, branching=16, seed=0)
    return dict(name=request.param, jmodel=jmodel, jparams=jparams,
                tmodel=Model(get_config(request.param).reduced()),
                tparams=params_from_numpy(_np_tree(jparams)),
                batches=list(j_batches(corpus, 3, B, T, seed=4)))


def _tbatch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# -- the SSD intra-chunk gradient -------------------------------------------------

@pytest.mark.parametrize("G", [1, 2])
def test_ssd_intra_bwd_plain_matches_jax_vjp_and_autograd(G):
    """Each of dxw, dB, dC and dl within 1e-5 of its largest magnitude of
    the reference's vjp, and of torch autograd through the plain version;
    ``ssd_intra`` (SSDIntraFn) on CPU tensors gives the closed form."""
    Bs, nc, Q, H, P, N = 2, 2, 16, 4, 8, 8
    rng = np.random.default_rng(10 + G)
    f32 = np.float32
    xw = rng.standard_normal((Bs, nc, Q, H, P)).astype(f32)
    Bm = rng.standard_normal((Bs, nc, Q, G, N)).astype(f32)
    Cm = rng.standard_normal((Bs, nc, Q, G, N)).astype(f32)
    l = (-np.cumsum(rng.uniform(0.01, 0.2, (Bs, nc, Q, H)), axis=2)).astype(f32)
    dy = rng.standard_normal((Bs, nc, Q, H, P)).astype(f32)
    dS = rng.standard_normal((Bs, nc, H, N, P)).astype(f32)
    want = jax.jit(lambda *a: jax.vjp(ssd_intra_ref, *a[:4])[1](a[4:]))(
        *(jnp.asarray(a) for a in (xw, Bm, Cm, l, dy, dS)))
    args = [torch.from_numpy(a) for a in (xw, Bm, Cm, l, dy, dS)]
    got = ssd_intra_bwd_plain(*args)
    for fn in (ssd_intra_plain, ssd_intra):
        ins = [a.clone().requires_grad_(True) for a in args[:4]]
        y, S = fn(*ins)
        auto = torch.autograd.grad((y * args[4]).sum() + (S * args[5]).sum(),
                                   ins)
        for a, c in zip(got, auto):
            assert a.shape == c.shape
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0,
                                       atol=1e-5 * float(c.abs().max()))
    for a, c in zip(got, want):
        assert a.shape == c.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=1e-5 * _max_abs([c]))


@pytest.mark.parametrize("T_", [16, 20], ids=["T16", "T20-padded"])
def test_ssd_chunked_gradients_match_reference(T_):
    """Gradients of the chunked scan (chunk 8: the inter-chunk recurrence
    differentiated) in all six inputs, within 1e-4 of each one's largest
    magnitude of ``jax.grad``'s."""
    rng = np.random.default_rng(T_)
    Bs, H, P, G, N, chunk = 2, 4, 8, 2, 8, 8
    f32 = np.float32
    ins = [rng.standard_normal((Bs, T_, H, P)).astype(f32),
           rng.standard_normal((Bs, T_, G, N)).astype(f32),
           rng.standard_normal((Bs, T_, G, N)).astype(f32),
           rng.uniform(0.01, 0.2, (Bs, T_, H)).astype(f32),
           np.log(rng.uniform(0.5, 4.0, (H,))).astype(f32),
           rng.standard_normal((H,)).astype(f32)]
    dy = rng.standard_normal((Bs, T_, H, P)).astype(f32)
    dh = rng.standard_normal((Bs, H, P, N)).astype(f32)

    def jloss(*a):
        y, h = jssm.ssd_chunked(*a, chunk)
        return jnp.sum(y * dy) + jnp.sum(h * dh)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *(jnp.asarray(a) for a in ins))
    tins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, h = tssm.ssd_chunked(*tins, chunk)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum()
                              + (h * torch.from_numpy(dh)).sum(), tins)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=1e-4 * _max_abs([c]))


def _tf32(a):
    """``cvt.rna.tf32.f32`` on a float32 tensor: round to nearest, ties
    away from zero, to TF32's 10 mantissa bits (the low 13 bits of the
    int32 view cleared after adding half of the last kept bit)."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_mm(eq, a, b, split):
    """``einsum(eq, a, b)`` as the backward kernel forms it on the tensor
    cores, float32 accumulators: ``split`` True, each operand as a TF32
    high part and a TF32 low part (hi = tf32(x), lo = tf32(x - hi)) and
    lo·hi + hi·lo + hi·hi; False, hi·hi alone (one TF32 product)."""
    ah, bh = _tf32(a), _tf32(b)
    hi = torch.einsum(eq, ah, bh)
    if not split:
        return hi
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + hi


def _ssd_intra_bwd_tf32(xw, Bm, Cm, l, dy, dS, split):
    """The closed form of ``ssd_intra_bwd_plain`` with every product (C·Bᵀ,
    dy·xwᵀ, Mᵀ·dy, (dM∘E)ᵀ·C, (dM∘E)·B, B·dS, xw·dSᵀ) taken through
    ``_split_mm``, in the kernel's order of the state terms (w·(B·dS),
    u_s = Σ_p xw_s·w_s·(B·dS)_s); the rest IEEE float32."""
    rep = xw.shape[3] // Bm.shape[3]
    Q = xw.shape[2]
    Bh = Bm.repeat_interleave(rep, dim=3)
    Ch = Cm.repeat_interleave(rep, dim=3)
    diff = l[:, :, :, None, :] - l[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()[None, None, :, :, None]
    E = torch.exp(torch.where(causal, diff, -1e30))
    M = _split_mm("bcqhn,bcshn->bcqsh", Ch, Bh, split) * E
    w = torch.exp(l[:, :, -1:, :] - l)
    Z = w[..., None] * _split_mm("bcshn,bchnp->bcshp", Bh, dS, split)
    dxw = _split_mm("bcqsh,bcqhp->bcshp", M, dy, split) + Z
    dM = _split_mm("bcqhp,bcshp->bcqsh", dy, xw, split)
    dME = dM * E
    dC = _split_mm("bcqsh,bcshn->bcqhn", dME, Bh, split)
    dB = (_split_mm("bcqsh,bcqhn->bcshn", dME, Ch, split)
          + w[..., None] * _split_mm("bcshp,bchnp->bcshn", xw, dS, split))
    Gm = dM * M
    u = torch.sum(xw * Z, dim=-1)
    dl = torch.sum(Gm, dim=3) - torch.sum(Gm, dim=2) - u
    dl[:, :, -1] += torch.sum(u, dim=2)
    shape = Bm.shape[:3] + (Bm.shape[3], rep, Bm.shape[4])
    return dxw, dB.reshape(shape).sum(dim=4), dC.reshape(shape).sum(dim=4), dl


@pytest.mark.parametrize("H,P,G,N,wide", [
    (2, 64, 1, 64, False),            # zamba2's P = N = 64
    (4, 64, 2, 128, False),           # mamba2's N = 128, G = 2
    (2, 64, 1, 64, True),             # |l| differences up to 30, inputs x 1e3
], ids=["zamba2", "mamba2-G2", "wide-range"])
def test_split_tf32_precision(H, P, G, N, wide):
    """The precision argument for the backward kernel's split TF32: the
    closed form with each product emulated as the kernel forms it, at Q =
    256, holds each of dxw, dB, dC and dl within 1e-4 of its largest
    magnitude of the reference's ``jax.vjp`` of ``ssd_intra_ref`` (the
    kernel's own tolerance on the card). One TF32 product (hi·hi) on the
    same inputs is reported beside it (``pytest -s``), and the split is
    the closer of the two."""
    Q = 256
    rng = np.random.default_rng(N + G + 10 * wide)
    f32 = np.float32
    scale = 1e3 if wide else 1.0
    xw, Bm, Cm = (rng.standard_normal(s).astype(f32) * f32(scale)
                  for s in ((1, 1, Q, H, P), (1, 1, Q, G, N), (1, 1, Q, G, N)))
    step = 30.0 / Q if wide else 0.05
    l = (-np.cumsum(rng.uniform(0.0, 2 * step, (1, 1, Q, H)), axis=2)).astype(f32)
    dy = rng.standard_normal((1, 1, Q, H, P)).astype(f32) * f32(scale)
    dS = rng.standard_normal((1, 1, H, N, P)).astype(f32) * f32(scale)
    want = jax.jit(lambda *a: jax.vjp(ssd_intra_ref, *a[:4])[1](a[4:]))(
        *(jnp.asarray(a) for a in (xw, Bm, Cm, l, dy, dS)))
    args = [torch.from_numpy(a) for a in (xw, Bm, Cm, l, dy, dS)]
    rel = {}
    for split in (True, False):
        got = _ssd_intra_bwd_tf32(*args, split)
        rel[split] = [float(np.max(np.abs(a.numpy() - np.asarray(c))))
                      / _max_abs([c]) for a, c in zip(got, want)]
    print(f"\nsplit TF32 vs jax.vjp, max |err| / max |ref| of dxw, dB, dC, "
          f"dl: 3xTF32 {', '.join(f'{r:.3g}' for r in rel[True])}; 1xTF32 "
          f"{', '.join(f'{r:.3g}' for r in rel[False])}")
    assert all(r <= 1e-4 for r in rel[True]), rel[True]
    assert max(rel[True]) < max(rel[False])


# -- the train loss and step ------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_grads_match_reference(lm, remat):
    """Loss within rtol 1e-4 and every gradient leaf within 1e-4 of the
    largest |g| of the reference's, remat off and on, on a padded T."""
    b = lm["batches"][0]
    loss, grads = loss_and_grads(lm["tmodel"], TrainConfig(
        remat=remat, loss_chunk=None), lm["tparams"], _tbatch(b))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: j_train_loss(
        lm["jmodel"], p, _jbatch(b), remat=remat == "block")))(lm["jparams"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    _assert_leaves_close([g.numpy() for g in tree_flatten(grads)],
                         jax.tree_util.tree_leaves(jg), 1e-4)


def test_remat_gradients_bit_identical_on_the_cpu(lm):
    """Checkpointing each layer and super-block changes no bit of the loss
    or of any gradient."""
    b = _tbatch(lm["batches"][1])
    out = {r: loss_and_grads(lm["tmodel"], TrainConfig(
        remat=r, loss_chunk=None), lm["tparams"], b) for r in ("none", "block")}
    assert torch.equal(out["none"][0], out["block"][0])
    for a, c in zip(tree_flatten(out["none"][1]),
                    tree_flatten(out["block"][1])):
        assert torch.equal(a, c)


@pytest.fixture(scope="module")
def zamba2_ref_steps():
    """Reduced zamba2: the reference's jitted train step three times (remat
    block) from JAX-initialised weights → (jmodel, jparams, batches, its
    (loss, gnorm) per step)."""
    jcfg = j_get_config("zamba2-2.7b").reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.key(6), dtype=jnp.float32)
    batches = list(j_batches(JCorpus(jcfg.vocab_size, branching=16, seed=1),
                             3, B, T, seed=8))
    jstep = jax.jit(j_make_train_step(jmodel, JTrainConfig(
        lr=2e-3, warmup_steps=1, total_steps=10, remat="block",
        loss_chunk=None)))
    jp, js, out = jparams, j_adamw_init(jparams), []
    for b in batches:
        jp, js, m = jstep(jp, js, _jbatch(b))
        out.append((float(m["loss"]), float(m["gnorm"])))
    return jparams, batches, out


@pytest.mark.parametrize("donate", [False, True])
def test_three_train_steps_match_the_reference(zamba2_ref_steps, donate):
    """Reduced zamba2, three steps (clip, cosine, AdamW, remat block): each
    step's loss and gnorm within rtol 1e-4 of the reference's; a donated
    step updates the params and moments in place."""
    jparams, batches, want = zamba2_ref_steps
    step = make_train_step(Model(get_config("zamba2-2.7b").reduced()),
                           TrainConfig(lr=2e-3, warmup_steps=1, total_steps=10,
                                       remat="block", loss_chunk=None),
                           donate=donate)
    tp = params_from_numpy(_np_tree(jparams))
    ts = adamw_init(tp)
    first = tree_flatten(tp)[0]
    for b, (jl, jn) in zip(batches, want):
        tp, ts, m = step(tp, ts, _tbatch(b))
        np.testing.assert_allclose(float(m["loss"]), jl, rtol=1e-4)
        np.testing.assert_allclose(float(m["gnorm"]), jn, rtol=1e-4)
    assert int(ts.step) == 3
    assert (tree_flatten(tp)[0] is first) == donate


def test_sliced_donated_adamw_bit_identical(monkeypatch):
    """The donated update, cut into slices of 7 elements, gives the
    functional update's bits, in the tensors it was given."""
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 5, 4), "b": (11,), "c": ()}
    mk = lambda s: {k: torch.from_numpy(rng.standard_normal(v).astype(
        np.float32)) for k, v in shapes.items()}
    params, grads = mk(0), mk(1)
    state = AdamWState(step=torch.tensor(4, dtype=torch.int32), mu=mk(2),
                       nu={k: v.abs() for k, v in mk(3).items()})
    lr = torch.tensor(3e-3)
    clipped, _ = clip_by_global_norm(grads, 0.5)
    want_p, want_s = adamw_update(clipped, state, params, lr)
    copy = lambda t: {k: v.clone() for k, v in t.items()}
    monkeypatch.setattr(adamw_mod, "SLICE", 7)
    p2 = copy(params)
    s2 = AdamWState(step=state.step, mu=copy(state.mu), nu=copy(state.nu))
    got_p, got_s = adamw_update(clipped, s2, p2, lr, donate=True)
    assert got_p["a"] is p2["a"] and got_s.mu["b"] is s2.mu["b"]
    assert got_s.nu["c"] is s2.nu["c"]
    for a, c in zip(tree_flatten((got_p, got_s)), tree_flatten((want_p, want_s))):
        assert torch.equal(a, c)


# -- checkpoints and the launchers ------------------------------------------------

def test_checkpoint_round_trip_of_the_stacked_trees(tmp_path, lm):
    """(params, AdamW state) of a stacked SSM / hybrid tree after a step
    save and load back bit for bit."""
    step = make_train_step(lm["tmodel"], TrainConfig(lr=1e-3, warmup_steps=1,
                                                     total_steps=5))
    tp, ts, _ = step(lm["tparams"], adamw_init(lm["tparams"]),
                     _tbatch(lm["batches"][0]))
    save_checkpoint(str(tmp_path), 1, (tp, ts), {"step": 1})
    template = (lm["tparams"], adamw_init(lm["tparams"]))
    (gp, gs), meta = load_checkpoint(str(tmp_path), template)
    assert meta == {"step": 1} and int(gs.step) == 1
    for a, c in zip(tree_flatten((gp, gs)), tree_flatten((tp, ts))):
        assert torch.equal(a, c)


def test_reference_zamba2_checkpoint_loads_into_the_port_template(tmp_path):
    """(params, AdamW state) of reduced zamba2 saved by the reference after
    one step load into the port's template leaf for leaf."""
    jcfg = j_get_config("zamba2-2.7b").reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.key(7), dtype=jnp.float32)
    b = next(iter(j_batches(JCorpus(jcfg.vocab_size, branching=16, seed=0),
                            1, B, T, seed=2)))
    jp, js, _ = jax.jit(j_make_train_step(jmodel, JTrainConfig(
        remat="none", loss_chunk=None)))(jparams, j_adamw_init(jparams),
                                         _jbatch(b))
    j_save(str(tmp_path), 1, (jp, js), {"step": 1})
    tparams = Model(get_config("zamba2-2.7b").reduced()).init(
        torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    (tp, ts), meta = load_checkpoint(str(tmp_path),
                                     (tparams, adamw_init(tparams)))
    assert meta == {} and int(ts.step) == 1
    for a, c in zip(tree_flatten((tp, ts)),
                    jax.tree_util.tree_leaves((jp, js))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_launch_train_zamba2_checkpoint_and_resume(tmp_path, capsys):
    args = ["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "40", "--log-every", "1",
            "--ckpt-dir", str(tmp_path)]
    assert train_cli.main(args + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("[train] step") == 2 and "saved checkpoint" in out
    assert latest_step(str(tmp_path)) == 2
    assert train_cli.main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and out.count("[train] step") == 1
    assert latest_step(str(tmp_path)) == 3
    # nothing left to train: it resumes and writes no checkpoint
    mtime = (tmp_path / "step_00000003" / "arrays.npz").stat().st_mtime_ns
    assert train_cli.main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "saved" not in out
    assert (tmp_path / "step_00000003" / "arrays.npz").stat().st_mtime_ns \
        == mtime


@pytest.mark.parametrize("arch,extra", [
    ("mamba2-1.3b", []),
    ("zamba2-2.7b", ["--scheduler", "--head", "screened-cuda", "--budget",
                     "256"]),
], ids=["mamba2", "zamba2-scheduler-screened-cuda"])
def test_launch_serve_trains_fits_and_serves_the_ssm_families(arch, extra,
                                                              capsys):
    """The serving launcher trains the model, fits the screen (a 128-word
    block screen for screened-cuda) and serves; the scheduler path has no
    page pool for these families."""
    argv = ["--arch", arch, "--reduced", "--l2s", "--device", "cpu",
            "--train-steps", "5", "--requests", "3", "--max-new", "4"]
    assert serve_cli.main(argv + extra) == 0
    out = capsys.readouterr().out
    assert "[serve] trained 5 steps" in out and "L2S fitted" in out
    if extra:
        assert "block=128" in out and "scheduler:" in out
        assert "kv pool" not in out
    else:
        assert "token agreement" in out
