"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs. Every test here needs a CUDA GPU and skips
without one. The file imports no JAX, so it also runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.fused_topk import (fused_screened_topk,
                                            fused_screened_topk_plain)
from repro_torch.kernels.ref import NEG_INF, topk_desc
from repro_torch.kernels.route import cluster_route, cluster_route_plain
from repro_torch.kernels.screen import screened_logits, screened_logits_plain

V_BLK = 128
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


def _inputs(cuda, weights, L=25_000, d=500, r=100, K=16, B=8, seed=7):
    g = torch.Generator().manual_seed(seed)
    W = torch.randn((L, d), generator=g)
    h = torch.randn((B, d), generator=g)
    if weights == "ties":                 # products exact in float32
        W, h, b = torch.round(W * 2) / 2, torch.round(h) * 0.5, torch.zeros(L)
    else:
        W, b = W * 0.05, torch.randn((L,), generator=g) * 0.1
    Wb, bb = ops.pack_head_blocks(W.to(cuda), b.to(cuda))
    n_blk = Wb.shape[0]
    ids = torch.randint(0, n_blk + 2, (B, K), generator=g, dtype=torch.int32)
    v = torch.randn((r, d), generator=g)
    return Wb, bb, h.to(cuda), ids.to(cuda), v.to(cuda)


@pytest.mark.parametrize("weights", ["normal", "ties"])
def test_cuda_kernels_match_plain(cuda, weights):
    Wb, bb, h, ids, v = _inputs(cuda, weights)
    B, n_blk = h.shape[0], Wb.shape[0]
    ops.reset_launches()
    torch.testing.assert_close(cluster_route(h, v), cluster_route_plain(h, v),
                               rtol=0, atol=0)
    raw = screened_logits(Wb, bb, h, ids)
    torch.testing.assert_close(raw, screened_logits_plain(Wb, bb, h, ids),
                               **TOL)
    valid = (ids < n_blk)[..., None]
    row = torch.where(valid, raw, NEG_INF).reshape(B, -1)
    lane = torch.arange(V_BLK, device=cuda, dtype=torch.int32)
    word = torch.where(valid, ids[..., None] * V_BLK + lane,
                       n_blk * V_BLK).reshape(B, -1)
    for k in (1, 5, 200):
        ki, kv, kz = fused_screened_topk(Wb, bb, h, ids, k=k)
        pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k=k)
        torch.testing.assert_close(kv, pv, **TOL)
        torch.testing.assert_close(kz, pz, **TOL)
        if weights == "ties":
            assert torch.equal(ki, pi) and torch.equal(kv, pv)
        # fused == masked unfused kernel logits + stable top-k, bit for bit
        uv, upos = topk_desc(row, k)
        assert torch.equal(kv, uv)
        assert torch.equal(ki, torch.gather(word, 1, upos))
    assert all(ops.LAUNCHES[k] > 0 for k in ("cluster_route", "screened_logits",
                                              "fused_screened_topk"))


def test_cuda_fused_all_sentinel_and_noise(cuda):
    Wb, bb, h, ids, _ = _inputs(cuda, "normal", L=1500, d=128, K=4, B=5)
    n_blk = Wb.shape[0]
    ids[2] = n_blk                                  # an all-sentinel row
    noise = ops.gumbel_noise((5, 4, V_BLK),
                             torch.Generator(device=cuda).manual_seed(0), cuda)
    ki, kv, kz = fused_screened_topk(Wb, bb, h, ids, k=5, noise=noise)
    pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k=5, noise=noise)
    torch.testing.assert_close(kv, pv, **TOL)
    torch.testing.assert_close(kz, pz, **TOL)
    assert torch.equal(ki, pi)
    assert bool((ki[2] == n_blk * V_BLK).all()) and bool(torch.isneginf(kz[2]))
    assert bool((kv[2] == NEG_INF).all()) and not bool(torch.isnan(kz).any())


@pytest.mark.parametrize("d", [37, 500, 2560])
@pytest.mark.parametrize("r", [1, 100, 1000])
@pytest.mark.parametrize("B", [1, 4, 130])
def test_cuda_cluster_route_matches_plain(cuda, B, r, d):
    """One cluster of blocks per 8 rows, one warp per cluster t: routes
    equal the plain argmax except where the plain top-2 scores lie within
    1e-5 relative (float32 sums in another order)."""
    g = torch.Generator().manual_seed(B * r + d)
    h = torch.randn((B, d), generator=g).to(cuda)
    v = torch.randn((r, d), generator=g).to(cuda)
    ops.reset_launches()
    got, want = cluster_route(h, v), cluster_route_plain(h, v)
    assert ops.LAUNCHES["cluster_route"] == 1
    scores = h @ v.T
    s_got = scores.gather(1, got.long()[:, None])[:, 0]
    s_want = scores.gather(1, want.long()[:, None])[:, 0]
    diff = got != want
    rel = (s_got - s_want).abs() / s_want.abs().clamp_min(1e-30)
    assert bool((rel[diff] < 1e-5).all()), (int(diff.sum()), rel[diff])
    assert bool(((got >= 0) & (got < r)).all())


@pytest.mark.parametrize("B", [1, 4, 130])
def test_cuda_cluster_route_tie_across_blocks(cuda, B):
    """Two clusters with equal (exact) scores in different blocks of the
    thread block cluster (t = 3 in block 0, t = 50 and t = 99 in later
    ones): the first index wins, as jnp.argmax."""
    g = torch.Generator().manual_seed(B)
    d, r = 500, 100
    v = torch.round(torch.randn((r, d), generator=g) * 2) / 2
    v[3] = v[50] = v[99] = 4.0
    h = torch.round(torch.rand((B, d), generator=g) * 3) * 0.5 + 0.5
    h, v = h.to(cuda), v.to(cuda)
    assert bool((cluster_route_plain(h, v) == 3).all())
    assert bool((cluster_route(h, v) == 3).all())


def test_cuda_wrappers_refuse_mixed_devices(cuda):
    Wb, bb, h, ids, v = _inputs(cuda, "normal", L=300, d=16, K=2, B=3)
    with pytest.raises(ValueError, match="expected cuda"):
        cluster_route(h, v.cpu())
    with pytest.raises(ValueError, match="expected cuda"):
        fused_screened_topk(Wb, bb, h, ids.cpu(), k=1)


def test_cuda_engine_fused_and_unfused_agree(cuda):
    """Reduced nmt-deen-lstm with a padded last block on the card: the
    fused and unfused screened-cuda heads decode the same tokens and beam,
    and both launched their kernels."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core.screening import candidates_to_padded
    from repro_torch.interop import screen_from_numpy
    from repro_torch.models import Model
    from repro_torch.serving import DecodeEngine

    cfg = replace(get_config("nmt-deen-lstm").reduced(), vocab_size=600)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    rng = np.random.default_rng(0)
    mask = rng.random((4, 5)) < 0.6
    mask[:, 4] = True
    idx, lens = candidates_to_padded(mask, 600, block=V_BLK)
    screen = screen_from_numpy(rng.standard_normal((4, 128)), idx, lens, 600,
                               V_BLK)
    prompts = rng.integers(0, 600, (3, 5))
    out = {}
    for fused in (True, False):
        eng = DecodeEngine(model, params, screen=screen,
                           head="screened-cuda",
                           head_kwargs={"fused": fused}, device=cuda)
        ops.reset_launches()
        out[fused] = (eng.generate(prompts, 8).tokens,
                      eng.beam_search(prompts[0], 4, 6))
        assert ops.LAUNCHES["cluster_route"] > 0
        assert ops.LAUNCHES["fused_screened_topk" if fused
                            else "screened_logits"] > 0
    np.testing.assert_array_equal(out[True][0], out[False][0])
    np.testing.assert_array_equal(out[True][1].tokens, out[False][1].tokens)
    np.testing.assert_allclose(out[True][1].scores, out[False][1].scores,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,nc,Q,H,P,G,N", [
    (2, 2, 256, 8, 64, 1, 64),        # zamba2's chunk, fewer heads
    (1, 1, 256, 4, 64, 2, 128),       # mamba2's N = 128 (B, C do not fit whole)
    (3, 1, 7, 6, 8, 2, 16),           # a short, odd chunk
    (1, 2, 100, 2, 72, 1, 20),        # ragged tiles in every dimension
    (2, 1, 1, 80, 64, 1, 128),        # Q = 1: one row, a one-row state
    (1, 2, 65, 80, 64, 1, 128),       # Q = 65: a one-row second t tile
    (1, 2, 256, 80, 64, 1, 128),      # zamba2's heads at mamba2's N
    (1, 1, 70, 3, 10, 3, 6),          # P, N not multiples of 4: 4-byte copies
])
def test_cuda_ssd_intra_matches_plain(cuda, B, nc, Q, H, P, G, N):
    from repro_torch.kernels.ssd import ssd_intra, ssd_intra_plain
    g = torch.Generator().manual_seed(Q + N)
    xw = torch.randn((B, nc, Q, H, P), generator=g)
    Bm = torch.randn((B, nc, Q, G, N), generator=g)
    Cm = torch.randn((B, nc, Q, G, N), generator=g)
    l = -torch.cumsum(torch.rand((B, nc, Q, H), generator=g) * 0.05, dim=2)
    args = [a.to(cuda) for a in (xw, Bm, Cm, l)]
    ops.reset_launches()
    y, S = ssd_intra(*args)
    py, pS = ssd_intra_plain(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_intra"] == 1
    for got, want in ((y, py), (S, pS)):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_cache_slot_update_bit_identical(cuda, dtype):
    from repro_torch.kernels.cache_update import (cache_slot_update,
                                                  cache_slot_update_plain)
    B, S, KV, hd = 4, 200, 3, 10          # rows of 60 / 30 bytes: no float4
    g = torch.Generator().manual_seed(1)
    cache = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    upd = torch.randn((B, KV, hd), generator=g).to(cuda, dtype)
    ops.reset_launches()
    for slot in (0, 127, S // 2, S - 1, S + 5, -1,
                 torch.tensor([3, S + 5, -1, S - 1], dtype=torch.int32,
                              device=cuda)):
        got = cache_slot_update(cache.clone(), upd, slot)
        want = cache_slot_update_plain(cache.clone(), upd, slot)
        assert torch.equal(got, want), slot
    assert ops.LAUNCHES["cache_slot_update"] == 7


def test_cuda_hybrid_engine_runs_the_ssm_kernels(cuda):
    """Reduced zamba2 on the card: prefill launches ssd_intra once per
    layer, decode writes the shared block's K/V through the cache kernel,
    and the greedy tokens of the kernel path equal the CPU plain path's
    on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import DecodeEngine

    cfg = get_config("zamba2-2.7b").reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    params["embed"]["embedding"] *= 20.0
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 40))
    ops.reset_launches()
    out = DecodeEngine(model, params, max_len=64, device=cuda).generate(prompts, 6)
    assert ops.LAUNCHES["ssd_intra"] == cfg.num_layers
    assert ops.LAUNCHES["cache_slot_update"] == 2 * cfg.num_layers * 5
    cpu = DecodeEngine(model, params, max_len=64, device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(out.tokens, cpu.tokens)
