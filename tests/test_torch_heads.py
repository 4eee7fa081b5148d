"""The port's screening functions and decode heads against the JAX package's
on the same seeded numpy inputs: ``assign_clusters``, both branches of
``screened_logits``, and the ``exact``, ``screened`` and ``screened-cuda``
heads (the latter against ``screened-pallas``, fused and unfused, kernels in
interpret mode) and the three sharded heads at 2 shards (the reference's
sharded heads over 2 of conftest's host devices; ``screened-sharded`` on
both shard-local backends). Ids are exactly equal; values within
rtol = atol = 1e-5.
Sampling hands both sides the same Gumbel noise. Also the guards: the
port's entry points raise without a GPU unless device="cpu" is given, and
no module of the port or of ``tools/``, nor ``chip_smoke.py`` or
``examples/quickstart_torch.py``, imports JAX or the reference package."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import heads as jheads
from repro.core import screening as jscreen
from repro.heads.base import adjust_logits as j_adjust
from repro_torch import heads
from repro_torch.core import screening
from repro_torch.heads.base import NEG_INF, adjust_logits
from repro_torch.interop import screen_from_numpy

V_BLK = 128
TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]


def _screen_pair(v, mask, vocab_size, block):
    idx, lens = jscreen.candidates_to_padded(mask, vocab_size, block=block)
    tidx, tlens = screening.candidates_to_padded(mask, vocab_size, block=block)
    np.testing.assert_array_equal(tidx, idx)
    np.testing.assert_array_equal(tlens, lens)
    jsp = jscreen.ScreenParams(v=jnp.asarray(v), cand_idx=jnp.asarray(idx),
                               cand_len=jnp.asarray(lens),
                               vocab_size=vocab_size, block=block)
    return jsp, screen_from_numpy(v, idx, lens, vocab_size, block)


@pytest.fixture(scope="module")
def fx():
    """L = 450 (not a multiple of 128: 4 blocks, the last padded); 4
    clusters with distinct block subsets, cluster 3 empty (all-sentinel),
    and a word-level screen over the same clusters."""
    rng = np.random.default_rng(11)
    L, d, r, B = 450, 48, 4, 12
    W = rng.standard_normal((L, d)).astype(np.float32)
    b = (rng.standard_normal(L) * 0.1).astype(np.float32)
    h = rng.standard_normal((B, d)).astype(np.float32)
    v = rng.standard_normal((r, d)).astype(np.float32)
    v[3] *= 3.0                                   # some rows route to it
    n_blk = -(-L // V_BLK)
    maskb = np.zeros((r, n_blk), bool)
    maskb[0, [0, 1, 3]] = True
    maskb[1, [1, 2]] = True
    maskb[2, :] = True
    maskw = np.repeat(maskb, V_BLK, axis=1)[:, :L]
    jb, tb = _screen_pair(v, maskb, L, V_BLK)
    jw, tw = _screen_pair(v, maskw, L, 1)
    return dict(W=W, b=b, h=h, L=L, B=B, jblock=jb, tblock=tb, jword=jw,
                tword=tw)


def _jhead(fx, name, screen=None, **kw):
    return jheads.get(name, W=jnp.asarray(fx["W"]), b=jnp.asarray(fx["b"]),
                      screen=screen, **kw)


def _thead(fx, name, screen=None, **kw):
    return heads.get(name, device="cpu", W=fx["W"], b=fx["b"], screen=screen,
                     **kw)


HEAD_PAIRS = [  # (port head, reference head, screen kind, kwargs)
    ("exact", "exact", None, {}),
    ("screened", "screened", "word", {}),
    ("screened", "screened", "block", {}),
    ("screened-cuda", "screened-pallas", "block", {"fused": True}),
    ("screened-cuda", "screened-pallas", "block", {"fused": False}),
    ("exact-sharded", "exact-sharded", None, {"n_shards": 2}),
    ("screened-sharded", "screened-sharded", "word", {"n_shards": 2}),
    ("screened-sharded", "screened-sharded", "block",
     {"n_shards": 2, "local": "cuda"}),
    ("adaptive-sharded", "adaptive-sharded", None,
     {"n_shards": 2, "shortlist": 200, "n_tails": 2}),
]
IDS = ["exact", "screened-word", "screened-block", "cuda-fused",
       "cuda-unfused", "exact-sharded", "sharded-word", "sharded-cuda",
       "adaptive-sharded"]
# the reference's names of the sharded heads' shard-local backends
J_LOCAL = {"torch": "jnp", "cuda": "pallas"}


def _pair(fx, tname, jname, kind, kw):
    js = None if kind is None else fx["j" + kind]
    ts = None if kind is None else fx["t" + kind]
    jkw = dict(kw, local=J_LOCAL[kw["local"]]) if "local" in kw else kw
    return _thead(fx, tname, ts, **kw), _jhead(fx, jname, js, **jkw)


def test_assign_clusters_matches(fx):
    want = np.asarray(jscreen.assign_clusters(fx["jblock"].v,
                                              jnp.asarray(fx["h"])))
    got = screening.assign_clusters(fx["tblock"].v, torch.from_numpy(fx["h"]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(want.tolist()) == {0, 1, 2, 3}     # every cluster is used


@pytest.mark.parametrize("kind", ["word", "block"])
def test_screened_logits_both_branches_match(fx, kind):
    h = jnp.asarray(fx["h"])
    cluster = jscreen.assign_clusters(fx["jblock"].v, h)
    jl, jids = jscreen.screened_logits(jnp.asarray(fx["W"]),
                                       jnp.asarray(fx["b"]), fx["j" + kind],
                                       h, cluster)
    tl, tids = screening.screened_logits(
        torch.from_numpy(fx["W"]), torch.from_numpy(fx["b"]), fx["t" + kind],
        torch.from_numpy(fx["h"]), torch.from_numpy(np.array(cluster)))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("tname,jname,kind,kw", HEAD_PAIRS, ids=IDS)
def test_head_queries_match(fx, tname, jname, kind, kw, k):
    """topk, topk_logprobs (empty row → NEG_INF, never NaN) and next."""
    th, jh = _pair(fx, tname, jname, kind, kw)
    h_t, h_j = torch.from_numpy(fx["h"]), jnp.asarray(fx["h"])
    ti, tv = th.topk(h_t, k)
    ji, jv = jh.topk(h_j, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    ti, tlp = th.topk_logprobs(h_t, k)
    ji, jlp = jh.topk_logprobs(h_j, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **TOL)
    assert not np.any(np.isnan(tlp.numpy()))
    np.testing.assert_array_equal(th.next(h_t).numpy(),
                                  np.asarray(jh.next(h_j)))
    if kind is not None:                          # rows routed to cluster 3
        empty = np.asarray(jscreen.assign_clusters(fx["jblock"].v, h_j)) == 3
        assert np.all(tlp.numpy()[empty] <= NEG_INF / 2)


@pytest.mark.parametrize("temperature,top_p", [(0.7, 1.0), (1.0, 0.9),
                                               (0.0, 1.0)])
@pytest.mark.parametrize("tname,jname,kind,kw", HEAD_PAIRS, ids=IDS)
def test_head_sample_matches_with_shared_noise(fx, tname, jname, kind, kw,
                                               temperature, top_p):
    """The reference draws argmax(logits + G) with G = gumbel(key, shape);
    the port gets that same G and must draw the same ids."""
    th, jh = _pair(fx, tname, jname, kind, kw)
    key = jax.random.key(3)
    B = fx["B"]
    if tname.endswith("-sharded"):
        shape = th.noise_shape(B, 1.0)       # the reference draws this shape
    elif tname == "exact":
        shape = (B, fx["L"])
    elif tname == "screened":
        shape = (B, fx["j" + kind].c_max * fx["j" + kind].block)
    elif kw["fused"] and top_p >= 1.0:
        shape = (B, fx["jblock"].c_max, V_BLK)
    else:
        shape = (B, fx["jblock"].c_max * V_BLK)
    g = np.asarray(jax.random.gumbel(key, shape, jnp.float32))
    want = np.asarray(jh.sample(key, jnp.asarray(fx["h"]), temperature, top_p))
    got = th.sample(torch.from_numpy(fx["h"]), temperature, top_p,
                    gumbel=torch.from_numpy(np.array(g)))
    np.testing.assert_array_equal(got.numpy(), want)
    # a drawn id is a real word except on the empty-cluster rows
    assert got.numpy().min() >= 0


@pytest.mark.parametrize("temperature,top_p", [(1.0, 0.5), (0.6, 0.75),
                                               (2.0, 0.3)])
def test_adjust_logits_top_p_under_duplicates(temperature, top_p):
    """Rank-based nucleus mask: with many duplicate logits exactly the
    smallest sorted prefix survives, the same positions as the reference."""
    rng = np.random.default_rng(5)
    logits = rng.choice(np.float32([0.0, 0.5, 1.0, 2.0]), (6, 40))
    logits[2, 30:] = NEG_INF
    logits[4] = 1.0                               # one row all equal
    want = np.asarray(j_adjust(jnp.asarray(logits), temperature, top_p))
    got = adjust_logits(torch.from_numpy(logits), temperature, top_p).numpy()
    np.testing.assert_array_equal(got <= NEG_INF / 2, want <= NEG_INF / 2)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.all((got > NEG_INF / 2).sum(-1) < 40)


def test_cost_models_match(fx):
    for tname, jname, kind, kw in HEAD_PAIRS:
        th, jh = _pair(fx, tname, jname, kind, kw)
        assert th.flops_per_query == pytest.approx(jh.flops_per_query)
        assert th.bytes_per_query == pytest.approx(jh.bytes_per_query)
    fused = _thead(fx, "screened-cuda", fx["tblock"])
    unfused = _thead(fx, "screened-cuda", fx["tblock"], fused=False)
    assert fused.bytes_per_query < unfused.bytes_per_query
    assert fused.packed_shape == (4, V_BLK, 48)


def test_registry_guards(fx):
    # the reference's heads, ``screened-pallas`` as ``screened-cuda``
    assert heads.names() == sorted(
        set(jheads.names()) - {"screened-pallas"} | {"screened-cuda"})
    assert heads.names() == [
        "adaptive", "adaptive-sharded", "exact", "exact-sharded",
        "greedy-mips", "lsh-mips", "pca-mips", "screened", "screened-cpu",
        "screened-cuda", "screened-sharded", "shortlist", "svd"]
    with pytest.raises(KeyError, match="unknown head"):
        _thead(fx, "screened-pallas")
    with pytest.raises(heads.MissingScreenError):
        _thead(fx, "screened-cuda")
    with pytest.raises(ValueError, match="block"):
        _thead(fx, "screened-cuda", fx["tword"])


def test_entry_points_need_a_gpu_unless_cpu_is_asked(fx):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import DecodeEngine
    model = Model(get_config("ptb-small-lstm").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        heads.get("exact", W=fx["W"], b=fx["b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(torch.Generator().manual_seed(0))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(model, params)


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\s|\.|$)",
                        re.MULTILINE)


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "tools").glob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
              ROOT / "examples" / "serve_batch_torch.py",
              ROOT / "examples" / "dryrun_multipod_torch.py"]
    assert len(files) > 20 and all(p.is_file() for p in files)
    port = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in files
            if "repro_torch" in p.parts}
    assert {"utils/timing.py", "serving/observe/trace.py",
            "serving/observe/metrics.py", "serving/resilience/faults.py",
            "serving/resilience/breaker.py", "serving/resilience/watchdog.py",
            "serving/scheduler/queue.py", "serving/scheduler/stats.py",
            "serving/scheduler/scheduler.py", "launch/serve.py",
            "heads/adaptive.py", "heads/adapters.py", "heads/sharded.py",
            "core/baselines.py", "core/lowrank.py", "kernels/ssd.py",
            "launch/train.py", "optim/adamw.py", "launch/op_cost.py",
            "launch/dryrun.py", "launch/roofline.py", "launch/mesh.py",
            "utils/pytree.py", "serving/observe/drift.py",
            "kernels/cost.py", "launch/sharding.py", "utils/shard.py"} <= port
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"
