"""The port's dense family (``smollm-360m``, ``gemma-2b``, ``starcoder2-3b``,
``qwen1.5-110b``) against the JAX package's, on reduced configs (d = 128,
2 layers, V = 512) with the reference's weights carried across with
``params_from_numpy`` (``torch_serving_fixtures.dense_fx``: the softmax
matrix × 20, so greedy steps are decided by gaps far above float32
rounding, asserted). Their configs are held field for field by
``tests/test_torch_ssm.py::test_configs_and_reduced_match_reference``,
which runs over the whole registry.

  * hidden states of ``forward``, ``prefill`` and 3 ``decode_step``s, and
    the K/V caches, within atol = 1e-4 (the reference tests' float32
    tolerance) — GeGLU and head_dim 256 (gemma), layernorm, gelu and qkv
    biases (starcoder2), GQA with kv = 5 (smollm), an untied ``lm_head``
    (qwen);
  * ``attn_decode_paged`` against the reference's (atol = 1e-5) and bit for
    bit against the port's own tensor-pos ``attn_decode`` over the same
    values (pages in scrambled order, stale pages poisoned); the model's
    ``decode_step_paged`` bit for bit against ``decode_step``;
  * greedy ``generate`` through ``exact``, ``screened`` and
    ``screened-cuda`` (fused; unfused on gemma) bit-identical to the
    reference engine's (``screened-pallas`` for the kernel head), and
    ``beam_search`` through the kernel head: the same top beam, its score
    within 1e-4;
  * a reduced gemma in bfloat16 on both sides: greedy tokens equal except
    rows that first differ after a step whose reference top-2 gap is below
    PR 21's bf16 margin (0.5);
  * the engine refuses a dense decode past ``max_len`` (the reference
    clamps its writes to slot S − 1), and ``remat`` leaves a dense forward
    and its gradients bit for bit as they were;
  * the serving launcher on a dense arch with ``--scheduler`` serves over
    a page pool, and the training launcher refuses a dense arch;
  * the kernels' limits at the dense shapes: the fused merge's shared
    memory at gemma-2b's full cover and qwen1.5-110b's width, the route
    at d = 8192, the exact head's stable top-k at V = 256,000.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import get_config as j_get_config
from repro.layers import attention as jattn
from repro.models.model import Model as JModel
from repro.serving.engine import DecodeEngine as JEngine
from repro_torch.configs import REGISTRY, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.layers import attention as tattn
from repro_torch.models import Model
from repro_torch.serving import DecodeEngine
from torch_serving_fixtures import DENSE_SEEDS, TWIN, assert_decided, \
    dense_fx

ARCHS = tuple(DENSE_SEEDS)
B, TP, NEW, MAX_LEN = 3, 12, 6, 24
BF16_MARGIN = 0.5          # PR 21's bf16 gap margin (tests/test_torch_bf16.py)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=ARCHS)
def fx(request):
    """One reduced dense model a parameter, with both packages' engines."""
    f = dense_fx(request.param)
    f["prompts"] = np.random.default_rng(5).integers(
        0, f["vocab"], (B, TP)).astype(np.int32)
    f["jeng"] = JEngine(f["jmodel"], f["jparams"], screen=f["jscreen"],
                        max_len=MAX_LEN)
    f["teng"] = DecodeEngine(f["tmodel"], f["tparams"], screen=f["tscreen"],
                             max_len=MAX_LEN, device="cpu")
    return f


def test_hidden_states_and_caches_match(fx):
    jm, jp, tm, tp = fx["jmodel"], fx["jparams"], fx["tmodel"], fx["tparams"]
    toks = fx["prompts"]
    jh, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    th, _ = tm.forward(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)

    jcache = jm.init_cache(B, MAX_LEN, dtype=jnp.float32)
    jh, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcache)
    tcache = tm.init_cache(B, MAX_LEN, dtype=torch.float32, device="cpu")
    th, tcache2 = tm.prefill(tp, {"tokens": _t(toks)}, tcache)
    assert tcache2 is tcache                       # filled in place
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    tok = toks[:, -1]
    for i in range(3):
        jh1, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache, TP + i)
        th1, tcache = tm.decode_step(tp, _t(tok), tcache, TP + i)
        np.testing.assert_allclose(th1.numpy(), np.asarray(jh1), atol=1e-4)
        tok = (tok * 7 + i) % fx["vocab"]
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache["attn"][k].numpy(),
                                   np.asarray(jcache["attn"][k]), atol=1e-4)


def test_attn_decode_paged_matches_reference_and_contiguous():
    """One gemma layer (MQA, head_dim 32 here): 4 rows at different depths
    over pages of 4 in a scrambled order, the stale pages poisoned with
    1e3. Against the reference's ``attn_decode_paged`` (outputs and pools,
    atol = 1e-5), and bit for bit against the port's ``attn_decode`` with
    the same (B,) positions on the contiguous cache the pages spell."""
    jcfg, tcfg = j_get_config("gemma-2b").reduced(), \
        get_config("gemma-2b").reduced()
    jp = jattn.attn_init(jax.random.key(3), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(3)
    Bq, P, n_pages, N = 4, 4, 6, 32
    S = n_pages * P
    KV, hd = tcfg.num_kv_heads, tcfg.head_dim
    dense = rng.standard_normal((2, Bq, S, KV, hd)).astype(np.float32)
    table = rng.permutation(np.arange(1, N))[:Bq * n_pages].reshape(
        Bq, n_pages).astype(np.int32)
    pool = np.full((2, N, P, KV, hd), 1e3, np.float32)   # poisoned
    for b in range(Bq):
        for j in range(n_pages):
            pool[:, table[b, j]] = dense[:, b, j * P:(j + 1) * P]
    pos = np.asarray([3, 9, 17, 23], np.int32)
    # rows past each position hold junk in both layouts
    for b in range(Bq):
        dense[:, b, pos[b] + 1:] = 7.0
        for s_ in range(pos[b] + 1, S):
            pool[:, table[b, s_ // P], s_ % P] = 7.0
    x1 = rng.standard_normal((Bq, 1, tcfg.d_model)).astype(np.float32)

    jo, jpk, jpv = jattn.attn_decode_paged(
        jp, jnp.asarray(x1), jnp.asarray(pool[0]), jnp.asarray(pool[1]),
        jnp.asarray(table), jnp.asarray(pos), jcfg)
    tpk, tpv = _t(pool[0]), _t(pool[1])
    to, opk, opv = tattn.attn_decode_paged(tp, _t(x1), tpk, tpv, _t(table),
                                           _t(pos), tcfg)
    assert opk is tpk and opv is tpv                # written in place
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(tpk.numpy(), np.asarray(jpk), atol=1e-5)
    np.testing.assert_allclose(tpv.numpy(), np.asarray(jpv), atol=1e-5)

    cache = {"k": _t(dense[0]), "v": _t(dense[1])}
    co, _ = tattn.attn_decode(tp, _t(x1), cache, _t(pos), tcfg)
    assert torch.equal(to, co)
    for b in range(Bq):                             # the same rows written
        pg, off = table[b, pos[b] // P], pos[b] % P
        assert torch.equal(tpk[pg, off], cache["k"][b, pos[b]])
        assert torch.equal(tpv[pg, off], cache["v"][b, pos[b]])


def test_decode_step_paged_bit_identical_to_decode_step(fx):
    """The whole stack: a prefill, its K/V written into pages of 4, then 3
    ``decode_step_paged`` steps against 3 ``decode_step`` steps at the same
    (B,) positions: hidden states and the written rows equal bit for bit."""
    tm, tp = fx["tmodel"], fx["tparams"]
    cfg = tm.cfg
    toks = _t(fx["prompts"])
    cache = tm.init_cache(B, MAX_LEN, dtype=torch.float32, device="cpu")
    _, cache = tm.prefill(tp, {"tokens": toks}, cache)
    P, n_pages = 4, MAX_LEN // 4
    table = torch.arange(1, 1 + B * n_pages, dtype=torch.int32).reshape(
        B, n_pages).flip(1).contiguous()
    L = cfg.num_layers
    pool = {k: torch.full((L, 1 + B * n_pages, P, cfg.num_kv_heads,
                           cfg.head_dim), 1e3) for k in ("k", "v")}
    for k in ("k", "v"):
        for b in range(B):
            pool[k][:, table[b].long()] = cache["attn"][k][:, b].reshape(
                L, n_pages, P, cfg.num_kv_heads, cfg.head_dim)
    tok = toks[:, -1]
    pos = torch.full((B,), TP, dtype=torch.int32)
    for i in range(3):
        h1, _ = tm.decode_step(tp, tok, cache, pos)
        h2, pool2 = tm.decode_step_paged(tp, tok, pool, table, pos)
        assert pool2 is pool and torch.equal(h1, h2)
        for b in range(B):
            pg, off = table[b, int(pos[b]) // P], int(pos[b]) % P
            for k in ("k", "v"):
                assert torch.equal(pool[k][:, pg, off],
                                   cache["attn"][k][:, b, int(pos[b])])
        tok = (tok * 7 + i) % fx["vocab"]
        pos = pos + 1


@pytest.mark.parametrize("tname,kw", [
    ("exact", {}), ("screened", {}), ("screened-cuda", {"fused": True})],
    ids=["exact", "screened", "cuda-fused"])
def test_greedy_generate_and_beam_match_reference(fx, tname, kw):
    jname = TWIN.get(tname, tname)
    jeng, teng = fx["jeng"], fx["teng"]
    if kw:
        jeng = JEngine(fx["jmodel"], fx["jparams"], screen=fx["jscreen"],
                       max_len=MAX_LEN, head_kwargs=kw)
        teng = DecodeEngine(fx["tmodel"], fx["tparams"], screen=fx["tscreen"],
                            max_len=MAX_LEN, head_kwargs=kw, device="cpu")
    want = np.asarray(jeng.generate(fx["prompts"], NEW, head=jname).tokens)
    for i in range(B):
        assert_decided(fx, fx["prompts"][i], want[i],
                       screened=tname != "exact")
    got = teng.generate(fx["prompts"], NEW, head=tname).tokens
    np.testing.assert_array_equal(got, want)
    if tname == "screened-cuda":                    # beam on the kernel head
        jb = jeng.beam_search(fx["prompts"][0], 4, NEW, head=jname)
        tb = teng.beam_search(fx["prompts"][0], 4, NEW, head=tname)
        np.testing.assert_array_equal(tb.tokens, jb.tokens)
        np.testing.assert_allclose(tb.scores, jb.scores, rtol=0, atol=1e-4)
    assert not any(ops.LAUNCHES.values())           # no kernel on the CPU


def test_unfused_kernel_head_matches_reference_on_gemma():
    f = dense_fx("gemma-2b")
    prompts = np.random.default_rng(6).integers(
        0, f["vocab"], (B, TP)).astype(np.int32)
    kw = {"fused": False}
    want = np.asarray(JEngine(f["jmodel"], f["jparams"], screen=f["jscreen"],
                              max_len=MAX_LEN, head_kwargs=kw).generate(
        prompts, NEW, head="screened-pallas").tokens)
    for i in range(B):
        assert_decided(f, prompts[i], want[i], screened=True)
    got = DecodeEngine(f["tmodel"], f["tparams"], screen=f["tscreen"],
                       max_len=MAX_LEN, head_kwargs=kw, device="cpu").generate(
        prompts, NEW, head="screened-cuda").tokens
    np.testing.assert_array_equal(got, want)


def test_gemma_bf16_greedy_within_the_bf16_margin():
    """gemma reduced with ``dtype="bfloat16"`` on both sides (bf16 weights
    carried bit for bit, bf16 caches): greedy tokens through exact equal
    the reference's, or a row first differs after a step whose reference
    top-2 gap is below BF16_MARGIN."""
    name = "gemma-2b"
    jcfg = replace(j_get_config(name).reduced(), dtype="bfloat16")
    tcfg = replace(get_config(name).reduced(), dtype="bfloat16")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(2))
    jp["embed"]["embedding"] = jp["embed"]["embedding"] * 20.0
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    assert tp["embed"]["embedding"].dtype == torch.bfloat16
    prompts = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (2, TP)).astype(np.int32)
    jeng = JEngine(jm, jp, max_len=MAX_LEN, cache_dtype=jnp.bfloat16)
    want = np.asarray(jeng.generate(prompts, NEW).tokens)
    got = DecodeEngine(Model(tcfg), tp, max_len=MAX_LEN,
                       cache_dtype=torch.bfloat16, device="cpu").generate(
        prompts, NEW).tokens
    cache = jm.init_cache(2, MAX_LEN, dtype=jnp.bfloat16)
    h, cache = jeng._jit_prefill(jp, {"tokens": jnp.asarray(prompts)}, cache)
    hs = [h[:, -1]]
    for i in range(NEW - 1):
        h1, cache = jeng._jit_decode(jp, jnp.asarray(want[:, i]), cache,
                                     TP + i)
        hs.append(h1)
    logits = np.asarray(jm.logits(jp, jnp.stack(hs, 1)), np.float32)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gaps = top2[..., 1] - top2[..., 0]
    for i in range(2):
        bad = np.nonzero(got[i] != want[i])[0]
        if bad.size:
            assert gaps[i, bad[0]] < BF16_MARGIN, (i, bad[0], gaps[i, bad[0]])


def test_dense_decode_past_max_len_is_refused():
    """A prompt of 10 and 5 new tokens need 15 cache slots: with max_len 8
    the port raises, where the reference clamps its writes to slot S − 1
    and decodes on over a corrupted cache."""
    f = dense_fx("smollm-360m")
    eng = DecodeEngine(f["tmodel"], f["tparams"], max_len=8, device="cpu")
    with pytest.raises(ValueError, match="max_len is 8"):
        eng.generate(np.zeros((2, 10), np.int32), 5)


def test_dense_remat_is_bit_identical():
    f = dense_fx("starcoder2-3b")
    tm = f["tmodel"]
    params = {k: v for k, v in f["tparams"].items()}
    leaves = [params["stack"]["blocks"]["attn"]["wq"],
              params["stack"]["blocks"]["mlp"]["w_up"]]
    toks = _t(np.random.default_rng(2).integers(0, f["vocab"], (2, 9)))
    out = []
    for remat in (False, True):
        for a in leaves:
            a.requires_grad_(True)
            a.grad = None
        h, _ = tm.forward(params, {"tokens": toks}, remat=remat)
        h.square().sum().backward()
        out.append((h.detach(), [a.grad.clone() for a in leaves]))
        for a in leaves:
            a.requires_grad_(False)
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_families_still_refused_and_gpu_default():
    """Every config of the reference's registry is in the port's and
    builds a ``Model`` (vlm and audio since tests/test_torch_vlm.py and
    test_torch_audio.py); only a family the reference does not have is
    still refused; a dense entry point raises without a GPU unless
    device='cpu' is asked for."""
    assert set(J_REGISTRY) <= set(REGISTRY)
    for name in J_REGISTRY:
        assert Model(get_config(name)).cfg.family == \
            j_get_config(name).family
    with pytest.raises(ValueError, match="unknown family"):
        replace(get_config("smollm-360m").reduced(), family="vision")
    if not torch.cuda.is_available():
        m = Model(get_config("gemma-2b").reduced())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            m.init_cache(2, 16)
        with pytest.raises(ValueError, match="max_len"):
            m.init_cache(2, device="cpu")


def test_launchers_on_a_dense_arch(capsys):
    """``launch.serve --scheduler`` on reduced smollm-360m serves over a
    page pool (its ``kv pool`` line), with a screened-cuda draft; the
    training launcher trains the dense family."""
    assert serve_cli.main([
        "--arch", "smollm-360m", "--reduced", "--l2s", "--scheduler",
        "--device", "cpu", "--train-steps", "3", "--requests", "6",
        "--max-new", "5", "--clusters", "4", "--budget", "256",
        "--head", "screened-cuda", "--draft-head", "screened-cuda"]) == 0
    out = capsys.readouterr().out
    assert "[serve] scheduler: kv pool" in out and "spec" in out
    assert train_cli.main(["--arch", "gemma-2b", "--reduced", "--device",
                           "cpu", "--steps", "1", "--batch", "2", "--seq",
                           "8", "--log-every", "1"]) == 0
    assert capsys.readouterr().out.count("[train] step") == 1


def test_kernel_limits_hold_at_the_dense_shapes():
    """The fused merge's shared memory at gemma-2b's full cover (2,000
    tiles a row) and at qwen1.5-110b's width (1,188 tiles of d = 8192)
    stays within the card's 227 KB at the parts the wrapper picks; the
    route takes d = 8192; and the exact head's top-k at V = 256,000 is the
    stable sort (ties to the lowest id), as the reference's ``top_k``."""
    from repro_torch.heads.exact import ExactHead
    from repro_torch.kernels.fused_topk import (SMEM_LIMIT, fused_parts,
                                                merge_smem_bytes)
    from repro_torch.kernels.route import MAX_D
    for K, d in ((2000, 2048), (1188, 8192), (16, 8192)):
        for B in (1, 4, 130):
            P = fused_parts(B, K, 132)
            assert merge_smem_bytes(K, P, d) <= SMEM_LIMIT, (K, d, B, P)
    assert MAX_D >= 8192
    W = torch.zeros((256_000, 4))
    W[[7, 300, 255_999, 90_000], 0] = 1.0          # four tied maxima
    ids, vals = ExactHead(W, torch.zeros(256_000)).topk(
        torch.ones((2, 4)), 3)
    assert ids.tolist() == [[7, 300, 90_000]] * 2
    assert vals.tolist() == [[1.0, 1.0, 1.0]] * 2
