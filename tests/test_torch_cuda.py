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
from repro_torch.testing import screen_id_patterns

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


# (B, K, k) of the split fused kernel: k in {1, 5, 128, 129, 130} wherever
# k <= K·128, and k = K·128 at K = 3; P = 8, 4, 2 or 1 parts per tile follow
FUSED_GRID = [(B, K, k) for B in (1, 4, 130) for K in (1, 3, 16, 200)
              for k in (1, 5, 128, 129, 130) if k <= K * V_BLK]
FUSED_GRID += [(B, 3, 3 * V_BLK) for B in (1, 4, 130)]


def _row_sentinels(ids, n_blk):
    """Sentinels in the middle of rows (both kinds: n_blk and -1), and the
    last row all sentinel when there are several rows."""
    K = ids.shape[1]
    ids[:, K // 2] = n_blk
    if K > 2:
        ids[::2, 1] = -1
    if ids.shape[0] > 1:
        ids[-1] = n_blk
    return ids


@pytest.mark.parametrize("B,K,k", FUSED_GRID)
def test_cuda_fused_split_matches_unfused(cuda, B, K, k):
    """The split kernel (blocks per row, slot and part, merged by the row's
    last block) == masked unfused kernel logits + stable top-k, bit for bit;
    values and logZ within 1e-5 of the plain version; sentinel ids and
    NEG_INF where a row has fewer than k real candidates."""
    Wb, bb, h, ids, _ = _inputs(cuda, "normal", L=3000, d=64, K=K, B=B,
                                seed=B * K + k)
    n_blk = Wb.shape[0]
    ids = _row_sentinels(ids, n_blk)
    raw = screened_logits(Wb, bb, h, ids)
    valid = ((ids >= 0) & (ids < n_blk))[..., None]
    row = torch.where(valid, raw, NEG_INF).reshape(B, -1)
    lane = torch.arange(V_BLK, device=cuda, dtype=torch.int32)
    word = torch.where(valid, ids[..., None] * V_BLK + lane,
                       n_blk * V_BLK).reshape(B, -1)
    ops.reset_launches()
    ki, kv, kz = fused_screened_topk(Wb, bb, h, ids, k=k)
    assert ops.LAUNCHES["fused_screened_topk"] == 1
    uv, upos = topk_desc(row, k)
    assert torch.equal(kv, uv)
    assert torch.equal(ki, torch.gather(word, 1, upos))
    pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k=k)
    torch.testing.assert_close(kv, pv, **TOL)
    fin = torch.isfinite(pz)
    assert torch.equal(fin, torch.isfinite(kz)) and bool(torch.isneginf(kz[~fin]).all())
    torch.testing.assert_close(kz[fin], pz[fin], **TOL)
    if B > 1:
        assert bool((ki[-1] == n_blk * V_BLK).all())
        assert bool((kv[-1] == NEG_INF).all()) and bool(torch.isneginf(kz[-1]))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_cuda_fused_tie_across_blocks(cuda, B, k):
    """Equal maxima in different slots and different parts of their tiles,
    so in different blocks (W = 0: every logit is its bias, exactly): the
    lowest flattened position wins, and the next ones follow in order."""
    n_blk, d, K = 40, 32, 16
    g = torch.Generator().manual_seed(k)
    W = torch.zeros((n_blk * V_BLK, d))
    b = torch.rand((n_blk * V_BLK,), generator=g)
    Wb, bb = ops.pack_head_blocks(W.to(cuda), b.to(cuda))
    ids = torch.randperm(n_blk, generator=g)[:K].to(torch.int32)
    ids = ids.repeat(B, 1).contiguous()
    # slot 2 row 120 (last part), slot 9 row 3 (first part), slot 5 row 64
    tied = [(2, 120), (9, 3), (5, 64)]
    for j, lane in tied:
        bb[int(ids[0, j]), lane] = 5.0
    h = torch.randn((B, d), generator=g).to(cuda)
    ids = ids.to(cuda)
    ki, kv, kz = fused_screened_topk(Wb, bb, h, ids, k=k)
    pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k=k)
    want = [int(ids[0, j]) * V_BLK + lane for j, lane in sorted(tied)]
    assert ki[:, :min(k, 3)].tolist() == [want[:k]] * B
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    torch.testing.assert_close(kz, pz, **TOL)


@pytest.mark.parametrize("K", [3, 16])
def test_cuda_fused_noise_and_determinism(cuda, K):
    """With noise (added after logZ) the split kernel matches its plain
    version; two calls on the same inputs are bit-identical in ids, vals
    and logZ (the merge combines the parts in a fixed order, no float
    atomics), and the per-row counters are left at zero."""
    from repro_torch.kernels import fused_topk
    B = 4
    Wb, bb, h, ids, _ = _inputs(cuda, "normal", L=5000, d=500, K=K, B=B)
    ids = _row_sentinels(ids, Wb.shape[0])
    noise = ops.gumbel_noise((B, K, V_BLK),
                             torch.Generator(device=cuda).manual_seed(K), cuda)
    for k in (1, 5, 130):
        a = fused_screened_topk(Wb, bb, h, ids, k=k, noise=noise)
        b = fused_screened_topk(Wb, bb, h, ids, k=k, noise=noise)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k=k,
                                               noise=noise)
        torch.testing.assert_close(a[1], pv, **TOL)
        fin = torch.isfinite(pz)
        torch.testing.assert_close(a[2][fin], pz[fin], **TOL)
        assert bool(torch.isneginf(a[2][~fin]).all())
        assert torch.equal(a[0], pi)
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0 for c in fused_topk._COUNTERS.values())


def _check_screen(Wb, bb, h, ids):
    """The gather kernel against its plain version (1e-5), bit for bit
    against the fused kernel's masked logits (k = K·128: every logit), the
    same bits at P = 1, 2, 4, 8 and on a second call; one launch counted."""
    from repro_torch.kernels import screen
    n_blk = Wb.shape[0]
    B, K = ids.shape
    ops.reset_launches()
    got = screened_logits(Wb, bb, h, ids)
    assert ops.LAUNCHES["screened_logits"] == 1
    torch.testing.assert_close(got, screened_logits_plain(Wb, bb, h, ids), **TOL)
    assert torch.equal(got, screened_logits(Wb, bb, h, ids))
    for parts in (1, 2, 4, 8):
        assert torch.equal(got, screen._launch(Wb, bb, h, ids, parts))
    valid = ((ids >= 0) & (ids < n_blk))[..., None]
    row = torch.where(valid, got, NEG_INF).reshape(B, -1)
    lane = torch.arange(V_BLK, device=h.device, dtype=torch.int32)
    word = torch.where(valid, ids[..., None] * V_BLK + lane,
                       n_blk * V_BLK).reshape(B, -1)
    ki, kv, _ = fused_screened_topk(Wb, bb, h, ids, k=K * V_BLK)
    uv, upos = topk_desc(row, K * V_BLK)
    assert torch.equal(kv, uv)
    assert torch.equal(ki, torch.gather(word, 1, upos))


# (d, B, pattern): ragged d (30, 130), the LSTM's 500 and zamba2's 2560; the
# beam pattern (4 groups of 5 rows) at B = 20 only
SCREEN_GRID = [(d, B, pat) for d in (30, 130, 500, 2560) for B in (1, 4, 20)
               for pat in ("random", "repeated_in_row", "shared_across_rows",
                           "one_cluster", "sentinels_and_tile0", "beam")
               if pat != "beam" or B == 20]


@pytest.mark.parametrize("d,B,pattern", SCREEN_GRID)
def test_cuda_screened_split_grid(cuda, d, B, pattern):
    """screen.cu's grid (a block per row, slot and part of the tile) on
    repeated ids within and across rows, one cluster for all rows,
    sentinels beside tile 0 and an all-sentinel row, and a beam."""
    g = torch.Generator().manual_seed(d * 100 + B)
    vocab = {30: 3000, 130: 3000, 500: 25_000, 2560: 32_000}[d]
    W = torch.randn((vocab, d), generator=g) * 0.05
    b = torch.randn((vocab,), generator=g) * 0.1
    Wb, bb = ops.pack_head_blocks(W.to(cuda), b.to(cuda))
    h = torch.randn((B, d), generator=g).to(cuda)
    ids = screen_id_patterns(g, Wb.shape[0], B, 16)[pattern]
    _check_screen(Wb, bb, h, ids.to(cuda))


@pytest.mark.parametrize("d", [130, 500])
def test_cuda_screened_full_cover(cuda, d):
    """Every row holds every tile (K = n_blk, padded with sentinels to a
    multiple of 8, as candidates_to_padded pads): each tile has B holders."""
    g = torch.Generator().manual_seed(d)
    W = torch.randn((25_000, d), generator=g) * 0.05
    b = torch.randn((25_000,), generator=g) * 0.1
    Wb, bb = ops.pack_head_blocks(W.to(cuda), b.to(cuda))
    n_blk = Wb.shape[0]
    K = -(-n_blk // 8) * 8
    ids = torch.full((4, K), n_blk, dtype=torch.int32)
    ids[:, :n_blk] = torch.arange(n_blk, dtype=torch.int32)
    h = torch.randn((4, d), generator=g).to(cuda)
    _check_screen(Wb, bb, h, ids.to(cuda))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_cache_kv_update_bit_identical(cuda, dtype):
    """K and V written in one launch, each bit-identical to the plain
    version: rows of 5,120 bytes (16-byte words) and of 60 / 30 bytes."""
    from repro_torch.kernels.cache_update import (cache_kv_update,
                                                  cache_slot_update_plain)
    g = torch.Generator().manual_seed(2)
    for B, S, KV, hd in ((4, 640, 32, 80), (3, 200, 3, 10)):
        ck, cv = (torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
                  for _ in range(2))
        uk, uv = (torch.randn((B, KV, hd), generator=g).to(cuda, dtype)
                  for _ in range(2))
        slots = (0, 127, S // 2, S - 1, S + 5, -1,
                 torch.tensor(([3, S + 5, -1, S - 1] * B)[:B],
                              dtype=torch.int32, device=cuda))
        for slot in slots:
            ops.reset_launches()
            gk, gv = cache_kv_update(ck.clone(), uk, cv.clone(), uv, slot)
            assert ops.LAUNCHES["cache_slot_update"] == 1
            assert torch.equal(gk, cache_slot_update_plain(ck.clone(), uk, slot))
            assert torch.equal(gv, cache_slot_update_plain(cv.clone(), uv, slot))


def test_cuda_hybrid_engine_runs_the_ssm_kernels(cuda):
    """Reduced zamba2 on the card: prefill launches ssd_intra once per
    layer, decode writes the shared block's K and V through one launch of
    the cache kernel,
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
    assert ops.LAUNCHES["cache_slot_update"] == cfg.num_layers * 5
    cpu = DecodeEngine(model, params, max_len=64, device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(out.tokens, cpu.tokens)


# -- the engine's CUDA graphs ---------------------------------------------------

def _graph_engine(cuda, family):
    """Reduced nmt-deen-lstm (V = 600, a padded last block) or reduced
    zamba2-2.7b on the card, with a 128-word block screen."""
    from repro_torch.configs import get_config
    from repro_torch.core.screening import candidates_to_padded
    from repro_torch.interop import screen_from_numpy
    from repro_torch.models import Model
    from repro_torch.serving import DecodeEngine

    if family == "lstm":
        from dataclasses import replace
        cfg = replace(get_config("nmt-deen-lstm").reduced(), vocab_size=600)
    else:
        cfg = get_config("zamba2-2.7b").reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    params["embed"]["embedding"] *= 20.0
    rng = np.random.default_rng(0)
    n_blk = -(-cfg.vocab_size // V_BLK)
    mask = rng.random((4, n_blk)) < 0.6
    mask[:, n_blk - 1] = True
    idx, lens = candidates_to_padded(mask, cfg.vocab_size, block=V_BLK)
    screen = screen_from_numpy(rng.standard_normal((4, cfg.d_model)), idx,
                               lens, cfg.vocab_size, V_BLK)
    eng = DecodeEngine(model, params, screen=screen, max_len=64, device=cuda)
    prompts = rng.integers(0, cfg.vocab_size, (3, 20))
    return eng, prompts


def _head(eng, name):
    from repro_torch.heads import AdaptiveHead, ScreenedCudaHead
    if name == "cuda-unfused":
        return ScreenedCudaHead(eng.W, eng.b, eng.screen, fused=False).prepare()
    if name.startswith("adaptive"):
        return AdaptiveHead(eng.W, eng.b, shortlist=200, n_tails=2,
                            fused=name == "adaptive-fused").prepare()
    return eng.resolve_head("screened-cuda" if name == "cuda-fused" else name)


GRAPH_HEADS = ["exact", "cuda-fused", "cuda-unfused", "adaptive-fused",
               "adaptive-unfused"]


@pytest.mark.parametrize("family", ["lstm", "hybrid"])
@pytest.mark.parametrize("name", GRAPH_HEADS)
def test_cuda_graph_tokens_equal_the_eager_step_body(cuda, family, name):
    """Greedy, sampled (top_p 1 and 0.9) and beam tokens of the graph
    replays equal the step bodies' run eagerly, bit for bit; one graph per
    (head, kind) at this width; replays count the launches eager runs make."""
    from repro_torch.testing import eager_beam_search, eager_generate
    eng, prompts = _graph_engine(cuda, family)
    hd = _head(eng, name)
    runs = [dict(), dict(temperature=0.9, seed=3),
            dict(temperature=0.9, top_p=0.9, seed=4)]
    for kw in runs:
        ops.reset_launches()
        got = eng.generate(prompts, 6, head=hd, **kw)
        ops.reset_launches()
        got = eng.generate(prompts, 6, head=hd, **kw)    # replays only
        replayed = dict(ops.LAUNCHES)
        ops.reset_launches()
        want = eager_generate(eng, prompts, 6, head=hd, **kw)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert replayed == ops.LAUNCHES, kw
    gb = eng.beam_search(prompts[0], 4, 6, head=hd)
    eb = eager_beam_search(eng, prompts[0], 4, 6, head=hd)
    np.testing.assert_array_equal(gb.tokens, eb.tokens)
    np.testing.assert_array_equal(gb.scores, eb.scores)
    counts = eng.compiled_step_counts()
    assert counts == {(hd.name, "greedy"): 1, (hd.name, "sample"): 2,
                      (hd.name, "decode"): 1}


@pytest.mark.parametrize("family", ["lstm", "hybrid"])
@pytest.mark.parametrize("name", GRAPH_HEADS)
def test_cuda_graph_sampled_tokens_equal_the_heads_own_draw(cuda, family,
                                                             name):
    """Graph-sampled tokens equal those the head's own ``sample(h,
    generator=...)`` draws from the same seed, the model stepped eagerly."""
    from repro_torch.testing import head_sampled_generate
    eng, prompts = _graph_engine(cuda, family)
    hd = _head(eng, name)
    for top_p in (1.0, 0.9):
        for _ in range(2):                              # capture, replay
            got = eng.generate(prompts, 6, head=hd, temperature=0.9,
                               top_p=top_p, seed=5)
            want = head_sampled_generate(eng, prompts, 6, hd, 0.9, top_p,
                                         seed=5)
            np.testing.assert_array_equal(got.tokens, want)


def test_cuda_slabs_freed_with_their_last_graph(cuda):
    """Widths 1..3 each keep one slab while their graphs live; once the LRU
    has evicted every graph, no slab is left, and a new one serves the
    next call."""
    from repro_torch.testing import eager_generate
    eng, prompts = _graph_engine(cuda, "lstm")
    hd = eng.resolve_head("screened-cuda")
    for B in (1, 2, 3):
        eng.generate(prompts[:B], 3, head=hd)
    assert sorted(eng._slabs) == [1, 2, 3]
    eng.generate(prompts[:1], 1, head="exact")      # runs no step
    assert sorted(eng._slabs) == [1, 2, 3]
    for i in range(32):                             # steps with no graph
        eng._sample_step(hd, 0.5 + 0.05 * i, 1.0)
    assert len(eng._slabs) == 0
    np.testing.assert_array_equal(
        eng.generate(prompts[:2], 4, head=hd).tokens,
        eager_generate(eng, prompts[:2], 4, head=hd).tokens)
    assert sorted(eng._slabs) == [2]


def test_cuda_graph_replay_adds_its_captured_launches(cuda):
    eng, prompts = _graph_engine(cuda, "hybrid")
    hd = eng.resolve_head("screened-cuda")
    eng.generate(prompts, 2, head=hd)                   # capture
    graph = eng._step_cache[(hd.step_key(), "greedy")].graphs[3]
    n_attn = eng.model.cfg.num_layers // eng.model.cfg.hybrid_shared_period
    assert graph.launches == {"cluster_route": 1, "fused_screened_topk": 1,
                              "cache_slot_update": n_attn}
    ops.reset_launches()
    with torch.inference_mode():
        graph.replay()
    assert {k: n for k, n in ops.LAUNCHES.items() if n} == graph.launches


def test_cuda_graphs_survive_eviction_and_wider_counters(cuda):
    """33 captures evict the first entry of the LRU of 32; a wider batch
    (B = 70) outgrows the fused kernel's counters. The graphs captured
    before both still replay the eager tokens."""
    from repro_torch.testing import eager_generate
    eng, prompts = _graph_engine(cuda, "lstm")
    hd = eng.resolve_head("screened-cuda")
    eng.generate(prompts, 3, head=hd)
    temps = [0.5 + 0.05 * i for i in range(32)]
    for t in temps:
        eng.generate(prompts, 3, head=hd, temperature=t, seed=1)
    assert eng._cache_size() == 32
    assert (hd.step_key(), "greedy") not in eng._step_cache
    wide = np.resize(prompts, (70, prompts.shape[1]))
    np.testing.assert_array_equal(eng.generate(wide, 4, head=hd).tokens,
                                  eager_generate(eng, wide, 4, head=hd).tokens)
    for t in temps[1:3]:
        got = eng.generate(prompts, 5, head=hd, temperature=t, seed=2)
        want = eager_generate(eng, prompts, 5, head=hd, temperature=t, seed=2)
        np.testing.assert_array_equal(got.tokens, want.tokens)


def test_cuda_serve_batch_adds_no_graph_when_repeated(cuda):
    from repro_torch.serving import CostAwarePolicy, ServeRequest
    eng, prompts = _graph_engine(cuda, "lstm")
    reqs = [ServeRequest(prompt=prompts[i % 3][:10 + 5 * (i % 2)],
                         max_new=3 + i % 3, k=1 + 4 * (i % 2),
                         accuracy_floor=1.0 if i % 4 == 3 else 0.0,
                         temperature=0.8 if i % 5 == 4 else None, seed=i)
            for i in range(10)]
    pol = CostAwarePolicy(["screened-cuda", "exact"])
    first = eng.serve_batch(reqs, policy=pol)
    counts = eng.compiled_step_counts()
    assert sum(counts.values()) > 0
    again = eng.serve_batch(reqs, policy=pol)
    assert eng.compiled_step_counts() == counts
    for req, a, b in zip(reqs, first, again):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        if req.temperature is None:
            solo = eng.generate(req.prompt[None], req.max_new, head=a.head)
            np.testing.assert_array_equal(solo.tokens[0], a.tokens)


# -- continuous batching on the card -----------------------------------------------

def _stream_run(eng, prompts, head="screened-cuda", width=3, injector=None,
                temperature=None):
    """Three requests (prompts of 20, 15 and 17 tokens, 6 new each) join a
    stream at ticks 0, 1 and 3; a step or join the guard refuses is run
    again. → (tokens by tag, the cache leaves after the last step that left
    a slot occupied, faults)."""
    from repro_torch.serving import HeadFault, ServeRequest
    from repro_torch.tree import tree_leaves
    s = eng.open_stream(head, width=width, temperature=temperature, seed=5)
    s.fault_injector = injector
    reqs = [ServeRequest(prompt=prompts[i][:n], max_new=6)
            for i, n in enumerate((20, 15, 17))]
    done, faults, leaves, tick = [], 0, None, 0
    joins = {0: 0, 1: 1, 3: 2}
    while tick == 0 or s.n_active or joins:
        if tick in joins:
            while True:
                try:
                    s.join(reqs[joins[tick]], tag=joins[tick])
                    break
                except HeadFault:
                    faults += 1
            del joins[tick]
        try:
            done += s.step()
        except HeadFault:
            faults += 1
            continue
        if s.cache is not None:
            leaves = [x.clone() for x in tree_leaves(s.cache)]
        tick += 1
    return {t: toks.tolist() for t, _, toks in done}, leaves, faults


@pytest.mark.parametrize("family", ["lstm", "hybrid"])
@pytest.mark.parametrize("name", ["exact", "cuda-fused", "cuda-unfused"])
def test_cuda_stream_graph_equals_its_eager_body(cuda, family, name):
    """A stream's graph replays (joins at three ticks, per-row positions)
    give the tokens, cache and launch counts of the same stream whose steps
    run their bodies eagerly, bit for bit; greedy and sampled."""
    for temperature in (None, 0.9):
        runs = []
        for eager in (False, True):
            eng, prompts = _graph_engine(cuda, family)
            if eager:
                eng._run = lambda step, slab: step.body(slab)
            hd = _head(eng, name)
            ops.reset_launches()
            runs.append(_stream_run(eng, prompts, hd,
                                    temperature=temperature)
                        + (dict(ops.LAUNCHES), eng.compiled_step_counts()))
        (got, gl, _, gn, gc), (want, wl, _, wn, wc) = runs
        assert got == want and gn == wn
        assert all(torch.equal(a, b) for a, b in zip(gl, wl))
        assert sum(gc.values()) == 1 and sum(wc.values()) == 0


def test_cuda_stream_slabs_are_lent_not_leaked(cuda):
    """A stream gives its slab back when it empties; the next stream of the
    step and width is lent the same slab and replays the graph captured on
    it. A generate at the width between them runs on its own slab."""
    eng, prompts = _graph_engine(cuda, "lstm")
    first, _, _ = _stream_run(eng, prompts)
    counts = eng.compiled_step_counts()
    assert counts == {("screened-cuda", "greedy"): 1}
    key = (3, (eng.resolve_head("screened-cuda").step_key(), "greedy"))
    free = [r() for r in eng._free_stream_slabs[key]]
    assert len(free) == 1 and free[0].pos.shape == (3,)
    eng.generate(prompts, 4, head="screened-cuda")     # generate's own slab
    assert eng.compiled_step_counts() == {("screened-cuda", "greedy"): 2}
    assert eng._slabs[3] is not free[0]
    again, _, _ = _stream_run(eng, prompts)
    assert again == first
    assert eng.compiled_step_counts() == {("screened-cuda", "greedy"): 2}
    assert [r() for r in eng._free_stream_slabs[key]] == free


def test_cuda_second_drain_adds_no_graph(cuda):
    """A second scheduler draining the same mixed traffic (greedy and
    sampled, two heads) on the engine adds no graph and gives the first
    drain's results bit for bit; greedy results equal serve_batch's."""
    from repro_torch.serving import (ContinuousScheduler, ServeRequest,
                                     ServeResult, TierPolicy)
    eng, prompts = _graph_engine(cuda, "lstm")
    tiers = ("realtime", "standard", "batch")
    reqs = [ServeRequest(prompt=prompts[i % 3][:12 + 4 * (i % 2)],
                         max_new=3 + i % 4, latency_tier=tiers[i % 3],
                         temperature=0.9 if i % 4 == 3 else None, seed=7)
            for i in range(10)]
    pol = TierPolicy({"realtime": "screened-cuda"}, default="exact")
    first = ContinuousScheduler(eng, policy=pol, max_slots=3).serve(reqs)
    counts = eng.compiled_step_counts()
    assert sum(counts.values()) > 0
    again = ContinuousScheduler(eng, policy=pol, max_slots=3).serve(reqs)
    assert eng.compiled_step_counts() == counts
    batch = eng.serve_batch(reqs, policy=pol)
    for req, a, b, c in zip(reqs, first, again, batch):
        assert isinstance(a, ServeResult) and a.head == b.head == c.head
        np.testing.assert_array_equal(a.tokens, b.tokens)
        if req.temperature is None:
            np.testing.assert_array_equal(a.tokens, c.tokens)


@pytest.mark.parametrize("family", ["lstm", "hybrid"])
def test_cuda_retried_stream_step_is_bit_identical(cuda, family):
    """Transient faults at two steps and one join, and a NaN corruption,
    each retried: the tokens and every cache leaf (LSTM state; SSM states,
    conv tails and K/V) equal the fault-free run's bit for bit."""
    from repro_torch.serving import FaultInjector
    eng, prompts = _graph_engine(cuda, family)
    clean, clean_leaves, n = _stream_run(eng, prompts)
    assert n == 0
    inj = FaultInjector(seed=0)
    inj.arm("step", "transient", count=2, after=3)
    inj.arm("join", "transient", count=1, after=2)
    inj.arm("step", "nan", count=1, after=7)
    got, leaves, n = _stream_run(eng, prompts, injector=inj)
    assert n == 4 and got == clean
    assert all(torch.equal(a, b) for a, b in zip(leaves, clean_leaves))


def test_cuda_stream_replay_device_calls_equal_counted_launches(cuda):
    """The profiler's device calls of each port kernel over a stream's
    replays (hybrid: route, fused top-k, the K/V cache pair) equal the
    launches the replays counted."""
    from torch.profiler import ProfilerActivity, profile
    names = {"cluster_route": "route_kernel",
             "fused_screened_topk": "fused_topk_kernel",
             "cache_slot_update": "cache_kv_update_kernel",
             "ssd_intra": "ssd_intra_kernel"}
    eng, prompts = _graph_engine(cuda, "hybrid")
    _stream_run(eng, prompts)                         # captures
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _stream_run(eng, prompts)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    seen = {k: sum(e.count for e in kern if sym in e.key)
            for k, sym in names.items()}
    counted = {k: ops.LAUNCHES[k] for k in names}
    assert seen == counted
    assert counted["cache_slot_update"] > 0 and counted["ssd_intra"] > 0


def test_cuda_train_step_matches_the_cpu(cuda):
    """One LM train step (loss, gradients, clip) of reduced ptb-small-lstm
    on the card against the same step on the CPU: gradients within 1e-4 of
    the largest |g|, loss and gnorm within rtol 1e-5; then a full step
    (AdamW) runs on the card and the loss falls over a few."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import ZipfMarkovCorpus, make_lm_batches
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import Model
    from repro_torch.models.model import to_device
    from repro_torch.optim import adamw_init, clip_by_global_norm
    from repro_torch.tree import tree_flatten

    cfg = get_config("ptb-small-lstm").reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    corpus = ZipfMarkovCorpus(cfg.vocab_size, branching=16, seed=0)
    batches = [{k: torch.as_tensor(x) for k, x in b.items()}
               for b in make_lm_batches(corpus, 6, 8, 24, seed=2)]
    tcfg = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=6, remat="none",
                       loss_chunk=None)
    got = {}
    for dev in ("cpu", cuda):
        p = to_device(params, dev)
        loss, grads = loss_and_grads(model, tcfg, p, {
            k: x.to(dev) for k, x in batches[0].items()})
        _, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        got[str(dev)] = (float(loss), float(gnorm),
                         [g.cpu() for g in tree_flatten(grads)])
    cpu, card = got["cpu"], got[str(cuda)]
    gmax = max(float(g.abs().max()) for g in cpu[2])
    for a, c in zip(card[2], cpu[2]):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-4 * gmax)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-5)

    step = make_train_step(model, tcfg)
    p = to_device(params, cuda)
    opt = adamw_init(p)
    losses = []
    for b in batches:
        p, opt, m = step(p, opt, {k: x.to(cuda) for k, x in b.items()})
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert int(opt.step) == len(batches) and opt.step.device.type == "cuda"


def test_cuda_fit_l2s_screen_routes_to_its_coverage(cuda):
    """A small block fit on the card: its screen, routed through the
    cluster_route kernel, gives back the coverage fit_l2s reports (rows
    whose top-2 cluster scores nearly tie aside), and screened-cuda decodes
    through it."""
    from repro_torch import heads
    from repro_torch.configs import L2SConfig
    from repro_torch.core import fit_l2s

    rng = np.random.default_rng(0)
    L, d, N = 1000, 64, 6000
    modes = rng.standard_normal((8, d)).astype(np.float32) * 3
    W = rng.standard_normal((L, d)).astype(np.float32)
    H = (modes[rng.integers(0, 8, N)] +
         0.3 * rng.standard_normal((N, d))).astype(np.float32)
    y = np.argsort(-(H @ W.T), axis=1)[:, :5].astype(np.int32)
    cfg = L2SConfig(num_clusters=8, budget=384, vocab_block=V_BLK,
                    outer_iters=2, sgd_steps=50, batch_size=256)
    st = fit_l2s(H, y, L, cfg, device=cuda)
    assert st.screen.v.device.type == "cuda"
    cov = st.history[-1]["coverage_best"]
    h = torch.as_tensor(H, device=cuda)
    ops.reset_launches()
    route = cluster_route(h, st.screen.v).cpu().numpy()
    assert ops.LAUNCHES["cluster_route"] == 1
    top2 = torch.topk(h @ st.screen.v.T, 2, dim=-1).values
    near = ((top2[:, 0] - top2[:, 1]) / top2[:, 0].abs()).cpu().numpy() < 1e-5
    hits = st.mask[route][np.arange(N)[:, None], y // V_BLK].sum()
    assert abs(hits - round(cov * y.size)) <= 5 * int(near.sum())
    head = heads.get("screened-cuda", W=W, b=np.zeros(L, np.float32),
                     screen=st.screen, device=cuda)
    ids, _ = head.topk(h[:64], 5)
    assert ids.shape == (64, 5) and ops.LAUNCHES["fused_screened_topk"] == 1


# -- the adaptive head's tiers and the host heads -----------------------------

@pytest.fixture(scope="module")
def tier_heads():
    """Packed heads at nmt-deen-lstm's width (d = 500, V = 25,000: 196
    blocks) and zamba2-2.7b's (d = 2560, V = 32,000: 250 blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    out = {}
    for d, L in ((500, 25_000), (2560, 32_000)):
        g = torch.Generator().manual_seed(d)
        W = torch.randn((L, d), generator=g) * 0.05
        b = torch.randn((L,), generator=g) * 0.1
        out[d] = ops.pack_head_blocks(W.cuda(), b.cuda())
    return out


def _tier_ids(n_blk, B, K, g):
    """(B, K) block ids of a tier: the short tier's blocks broadcast over
    the rows (K = 16, 196, 250), or a tail tier's (K = 45) with every other
    row masked to the sentinel (a row whose gate lost)."""
    if K != 45:
        return torch.arange(K, dtype=torch.int32).repeat(B, 1).contiguous()
    ids = torch.randint(0, n_blk, (B, K), generator=g, dtype=torch.int32)
    ids[::2] = n_blk
    return ids.contiguous()


TIER_GRID = [(B, K, k) for K in (16, 45, 196, 250) for k in (1, 5, 64)
             for B in (1, 4)]


@pytest.mark.parametrize("B,K,k", TIER_GRID)
def test_cuda_tier_fused_topk_at_tier_shapes(cuda, tier_heads, B, K, k):
    """``tier_fused_topk`` at the adaptive head's tier shapes against its
    plain version (values and logZ within 1e-5) and bit for bit against the
    masked gather kernel + stable top-k; all-sentinel rows give sentinel
    ids, NEG_INF values and logZ = -inf."""
    d = 2560 if K == 250 else 500
    Wb, bb = tier_heads[d]
    n_blk = Wb.shape[0]
    g = torch.Generator().manual_seed(B * 1000 + K * 10 + k)
    h = torch.randn((B, d), generator=g).to(cuda)
    ids = _tier_ids(n_blk, B, K, g).to(cuda)
    ops.reset_launches()
    ki, kv, kz = ops.tier_fused_topk(Wb, bb, h, ids, k=k)
    assert ops.LAUNCHES["fused_screened_topk"] == 1
    pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k)
    torch.testing.assert_close(kv, pv, **TOL)
    fin = torch.isfinite(pz)
    assert torch.equal(fin, torch.isfinite(kz))
    torch.testing.assert_close(kz[fin], pz[fin], **TOL)
    valid = ((ids >= 0) & (ids < n_blk))[..., None]
    row = torch.where(valid, screened_logits(Wb, bb, h, ids),
                      NEG_INF).reshape(B, -1)
    lane = torch.arange(V_BLK, device=cuda, dtype=torch.int32)
    word = torch.where(valid, ids[..., None] * V_BLK + lane,
                       n_blk * V_BLK).reshape(B, -1)
    uv, upos = topk_desc(row, k)
    assert torch.equal(kv, uv) and torch.equal(ki, torch.gather(word, 1, upos))
    dead = ~valid[..., 0].any(1)
    assert bool((ki[dead] == n_blk * V_BLK).all())
    assert bool((kv[dead] == NEG_INF).all()) and bool(torch.isneginf(
        kz[dead]).all())


def test_cuda_fused_parts_fall_back_to_one_part(cuda, tier_heads):
    """zamba2-2.7b, B = 1, the short tier of all 250 blocks: the grid
    rule's P = 2 serves every k. At k = 64 (once launched at P = 1) and
    k = 128 (once refused: 227 KB) the merge holds only the lists' heads
    and reads the lists from L2. Each against the plain version, and bit
    for bit against the masked gather kernel + stable top-k."""
    from repro_torch.kernels.fused_topk import (SMEM_LIMIT, _sm_count,
                                                fused_parts, merge_smem_bytes)
    Wb, bb = tier_heads[2560]
    h = torch.randn((1, 2560), generator=torch.Generator().manual_seed(3))
    h = h.to(cuda)
    ids = torch.arange(250, dtype=torch.int32, device=cuda)[None]
    assert fused_parts(1, 250, _sm_count(h.device)) == 2
    assert merge_smem_bytes(250, 2, 2560) <= SMEM_LIMIT
    row = screened_logits(Wb, bb, h, ids).reshape(1, -1)
    for k in (32, 64, 128):
        ki, kv, kz = fused_screened_topk(Wb, bb, h, ids, k=k)
        pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k)
        torch.testing.assert_close(kv, pv, **TOL)
        torch.testing.assert_close(kz, pz, **TOL)
        uv, upos = topk_desc(row, k)
        assert torch.equal(kv, uv) and torch.equal(ki, upos.to(torch.int32))


def _bf16_inputs(cuda, d, L, B, K, seed, ties=False):
    """A bfloat16 packed head, h and block ids (some sentinel), and a
    float32 v of 100 clusters. ``ties``: weights and h on a 0.5 grid, so
    every product and partial sum is exact in float32."""
    g = torch.Generator().manual_seed(seed)
    W = torch.randn((L, d), generator=g)
    h = torch.randn((B, d), generator=g)
    if ties:
        W, h, b = torch.round(W * 2) / 2, torch.round(h) * 0.5, torch.zeros(L)
    else:
        W, b = W * 0.05, torch.randn((L,), generator=g) * 0.1
    Wb, bb = ops.pack_head_blocks(W.to(cuda, torch.bfloat16),
                                  b.to(cuda, torch.bfloat16))
    n_blk = Wb.shape[0]
    ids = torch.randint(0, n_blk + 2, (B, K), generator=g, dtype=torch.int32)
    v = torch.randn((100, d), generator=g)
    return Wb, bb, h.to(cuda, torch.bfloat16), ids.to(cuda), v.to(cuda)


@pytest.mark.parametrize("B", [1, 4, 130])
@pytest.mark.parametrize("d", [500, 2560])
def test_cuda_bf16_kernels_match_plain(cuda, d, B):
    """The bfloat16 bodies of the route, gather and fused kernels against
    their plain versions on the same bf16 inputs: routes equal, logits,
    values and logZ within 1e-5 (each bf16 product is exact in float32,
    so only the order of the float32 sums differs); fused == unfused bit
    for bit; only the bf16 counters move."""
    Wb, bb, h, ids, v = _bf16_inputs(cuda, d, 25_000 if d == 500 else 32_000,
                                     B, 16, seed=d + B)
    n_blk = Wb.shape[0]
    ops.reset_launches()
    assert torch.equal(cluster_route(h, v), cluster_route_plain(h, v))
    raw = screened_logits(Wb, bb, h, ids)
    assert raw.dtype == torch.float32
    torch.testing.assert_close(raw, screened_logits_plain(Wb, bb, h, ids),
                               **TOL)
    valid = ((ids >= 0) & (ids < n_blk))[..., None]
    row = torch.where(valid, raw, NEG_INF).reshape(B, -1)
    lane = torch.arange(V_BLK, device=cuda, dtype=torch.int32)
    word = torch.where(valid, ids[..., None] * V_BLK + lane,
                       n_blk * V_BLK).reshape(B, -1)
    noise = ops.gumbel_noise((B, 16, V_BLK),
                             torch.Generator(device=cuda).manual_seed(d), cuda)
    for k in (1, 5, 129):
        for nz in (None, noise):
            ki, kv, kz = fused_screened_topk(Wb, bb, h, ids, k=k, noise=nz)
            pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k, nz)
            torch.testing.assert_close(kv, pv, **TOL)
            torch.testing.assert_close(kz, pz, **TOL)
            if nz is None:
                uv, upos = topk_desc(row, k)
                assert torch.equal(kv, uv)
                assert torch.equal(ki, torch.gather(word, 1, upos))
    assert all(ops.LAUNCHES[name] == 0 for name in ("cluster_route",
               "screened_logits", "fused_screened_topk"))
    assert ops.LAUNCHES["cluster_route_bf16"] == 1
    assert ops.LAUNCHES["screened_logits_bf16"] == 1
    assert ops.LAUNCHES["fused_screened_topk_bf16"] == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [115, 128, 129])
@pytest.mark.parametrize("K", [225, 250])
def test_cuda_fused_serves_every_k(cuda, K, k, dtype):
    """The shapes the merge once refused (K >= 225 tiles at k >= 115..128):
    on weights and h of a 0.5 grid (every sum exact in float32) ids, values
    and logZ equal the plain version's bit for bit, at B = 1 and 4, with
    mid-row and all-sentinel rows; and fused == unfused."""
    d = 2560
    Wb, bb, h, _, _ = _bf16_inputs(cuda, d, 32_000, 4, K, seed=K + k,
                                   ties=True)
    Wb, bb, h = Wb.to(dtype), bb.to(dtype), h.to(dtype)
    n_blk = Wb.shape[0]
    ids = torch.stack([torch.randperm(n_blk, generator=torch.Generator()
                                      .manual_seed(K * 4 + i))[:K]
                       for i in range(4)]).to(torch.int32).to(cuda)
    ids = _row_sentinels(ids, n_blk)
    for B in (1, 4):
        hb, ib = h[:B].contiguous(), ids[:B].contiguous()
        ki, kv, kz = fused_screened_topk(Wb, bb, hb, ib, k=k)
        pi, pv, pz = fused_screened_topk_plain(Wb, bb, hb, ib, k)
        assert torch.equal(ki, pi) and torch.equal(kv, pv)
        fin = torch.isfinite(pz)
        assert torch.equal(fin, torch.isfinite(kz))
        torch.testing.assert_close(kz[fin], pz[fin], **TOL)
        valid = ((ib >= 0) & (ib < n_blk))[..., None]
        row = torch.where(valid, screened_logits(Wb, bb, hb, ib),
                          NEG_INF).reshape(B, -1)
        uv, _ = topk_desc(row, k)
        assert torch.equal(kv, uv)


@pytest.mark.parametrize("family", ["lstm", "hybrid"])
def test_cuda_adaptive_fused_equals_unfused_in_graphs(cuda, family):
    """Through the engine's graphs the adaptive head's fused path (two
    fused top-k launches a step) and its unfused path (the gather kernel)
    decode the same greedy tokens and beam; the fused greedy step launches
    the fused kernel twice a replay."""
    eng, prompts = _graph_engine(cuda, family)
    fused = _head(eng, "adaptive-fused")
    unfused = _head(eng, "adaptive-unfused")
    eng.generate(prompts, 2, head=fused)               # capture
    ops.reset_launches()
    a = eng.generate(prompts, 6, head=fused)
    assert ops.LAUNCHES["fused_screened_topk"] == 2 * 6
    b = eng.generate(prompts, 6, head=unfused)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    ba = eng.beam_search(prompts[0], 4, 6, head=fused)
    bb = eng.beam_search(prompts[0], 4, 6, head=unfused)
    np.testing.assert_array_equal(ba.tokens, bb.tokens)


def test_cuda_host_head_slabs_freed_with_their_entries(cuda):
    """A host head's entries own the model's graphs and the slabs those
    hold, generate's and a stream's: once the LRU has evicted the entries,
    the graphs are gone, no slab is left and the free stream slab's weak
    reference is dead."""
    from repro_torch.heads import GreedyMIPSHead
    eng, prompts = _graph_engine(cuda, "lstm")
    hd = GreedyMIPSHead(eng.W, eng.b, budget=96)
    for B in (1, 2):
        eng.generate(prompts[:B], 3, head=hd)
    assert sorted(eng._slabs) == [1, 2]
    _stream_run(eng, prompts, head=hd)
    assert eng.host_model_graphs() == 3
    key = (3, (hd.step_key(), "greedy"))
    assert [r() is None for r in eng._free_stream_slabs[key]] == [False]
    sc = eng.resolve_head("screened-cuda")
    for i in range(32):                             # steps with no graph
        eng._sample_step(sc, 0.5 + 0.05 * i, 1.0)
    assert eng.host_model_graphs() == 0 and len(eng._slabs) == 0
    assert [r() is None for r in eng._free_stream_slabs[key]] == [True]


def test_cuda_host_head_between_graph_replays(cuda):
    """A host head (full-rank svd, greedy-mips) in a graph-backed
    generate: tokens equal the eager step bodies', the host head's steps
    hold no graph while the model's decode holds one per width, a second
    run adds none, sampled decoding is reproducible from its seed, and a
    stream through greedy-mips gives each request's solo tokens."""
    from repro_torch.heads import GreedyMIPSHead, SVDHead
    from repro_torch.testing import eager_beam_search, eager_generate
    eng, prompts = _graph_engine(cuda, "lstm")
    L, d = eng.W.shape
    for hd in (SVDHead(eng.W, eng.b, rho=d, n_top=L),
               GreedyMIPSHead(eng.W, eng.b, budget=96)):
        got = [eng.generate(prompts, 6, head=hd) for _ in range(2)]
        want = eager_generate(eng, prompts, 6, head=hd)
        for g in got:
            np.testing.assert_array_equal(g.tokens, want.tokens)
        s = [eng.generate(prompts, 6, head=hd, temperature=0.8, seed=2)
             for _ in range(2)]
        np.testing.assert_array_equal(s[0].tokens, s[1].tokens)
        gb = eng.beam_search(prompts[0], 3, 5, head=hd)
        eb = eager_beam_search(eng, prompts[0], 3, 5, head=hd)
        np.testing.assert_array_equal(gb.tokens, eb.tokens)
    counts = eng.compiled_step_counts()
    assert all(n == 0 for n in counts.values()), counts
    assert eng.host_model_graphs() == 6        # greedy, sample, decode × 2
    got, _, _ = _stream_run(eng, prompts, head=hd)
    for tag, n in enumerate((20, 15, 17)):
        solo = eng.generate(prompts[tag][None, :n], 6, head=hd)
        assert got[tag] == solo.tokens[0].tolist()


# -- speculative decoding and the page pool on the card ------------------------

def _spec_run(eng, prompts, draft="screened-cuda", width=3, draft_len=3,
              temperature=None):
    """Three requests (prompts of 20, 15 and 17 tokens, 8 new each) on a
    spec stream, all joined at once. → (tokens by tag, the stream)."""
    from repro_torch.serving import ServeRequest
    s = eng.open_spec_stream(draft, "exact", width=width, draft_len=draft_len,
                             temperature=temperature, seed=5)
    for i, n in enumerate((20, 15, 17)):
        s.join(ServeRequest(prompt=prompts[i][:n], max_new=8), tag=i)
    done = {}
    while not s.idle:
        done.update({t: toks.tolist() for t, _, toks in s.step()})
    return done, s


def _near_tie_steps(eng, prompt, tokens, gap=1e-4):
    """The steps of the exact greedy decode of ``prompt`` into ``tokens``
    whose top-2 logit gap is below ``gap`` (model.forward on the card)."""
    seq = torch.as_tensor(np.concatenate([prompt, tokens[:-1]])[None],
                          device="cuda")
    with torch.inference_mode():
        h, _ = eng.model.forward(eng.params, {"tokens": seq})
        top = eng.model.logits(eng.params, h[0, len(prompt) - 1:]).topk(
            2, dim=-1).values
    return set(np.nonzero((top[:, 0] - top[:, 1]).cpu().numpy() < gap)[0])


@pytest.mark.parametrize("family", ["lstm", "hybrid"])
def test_cuda_spec_greedy_matches_a_plain_exact_stream(cuda, family):
    """Greedy spec tokens (verify over 3 × 3 rows at once) equal a plain
    width-3 exact stream's except after a step whose top-2 gap is below
    1e-4; rejections happen on the random screen; the spec graphs replay
    what their eager bodies do, bit for bit, with equal launch counts."""
    from repro_torch.serving import ServeRequest
    eng, prompts = _graph_engine(cuda, family)
    got, s = _spec_run(eng, prompts)
    c = s.spec_counters()
    assert c["drafted"] > c["accepted"] and s.restored_rows > 0
    plain = eng.open_stream("exact", width=3)
    for i, n in enumerate((20, 15, 17)):
        plain.join(ServeRequest(prompt=prompts[i][:n], max_new=8), tag=i)
    want = {}
    while plain.n_active:
        want.update({t: toks.tolist() for t, _, toks in plain.step()})
    for i, n in enumerate((20, 15, 17)):
        bad = [j for j, (a, b) in enumerate(zip(got[i], want[i])) if a != b]
        assert not bad or bad[0] in _near_tie_steps(
            eng, prompts[i][:n], np.asarray(want[i]))
    runs = []
    for eager in (False, True):
        e, ps = _graph_engine(cuda, family)
        if eager:
            e._run = lambda step, slab: step.body(slab)
        _spec_run(e, ps)                                 # capture
        ops.reset_launches()
        runs.append((_spec_run(e, ps)[0], dict(ops.LAUNCHES),
                     e.compiled_step_counts()))
    (g, gn, gc), (w, wn, wc) = runs
    assert g == w and gn == wn
    assert gc == {("screened-cuda", "greedy"): 1, ("exact", "spec-verify"): 1}
    assert sum(wc.values()) == 0


def test_cuda_spec_second_stream_and_sampled_runs_add_no_graph(cuda):
    """A second spec stream of the same shape is lent the first's slab and
    adds no graph, greedy and sampled (T = 1); a sampled run from one seed
    repeats bit for bit."""
    eng, prompts = _graph_engine(cuda, "lstm")
    first, _ = _spec_run(eng, prompts)
    s1, _ = _spec_run(eng, prompts, temperature=1.0)
    counts = eng.compiled_step_counts()
    assert counts[("screened-cuda", "spec-dist")] == 1
    assert _spec_run(eng, prompts)[0] == first
    assert _spec_run(eng, prompts, temperature=1.0)[0] == s1
    assert eng.compiled_step_counts() == counts


def test_cuda_spec_graphs_freed_when_evicted(cuda):
    """The spec slab (its round buffers and snapshot ring) lives while a
    graph captured on it does: once the LRU has evicted the draft and
    verify steps, the slab is gone and its memory with it."""
    import gc
    import weakref
    eng, prompts = _graph_engine(cuda, "hybrid")
    _, s = _spec_run(eng, prompts)
    key = (3, s._slab_key())
    slab = weakref.ref(eng._free_stream_slabs[key][0]())
    assert slab() is not None and slab().spec.ring_nbytes > 0
    hd = eng.resolve_head("screened-cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for i in range(32):                             # steps with no graph
        eng._sample_step(hd, 0.5 + 0.05 * i, 1.0)
    gc.collect()
    assert slab() is None
    assert eng.compiled_step_counts() == {("screened-cuda", "sample"): 0}
    assert torch.cuda.memory_allocated() < before


def test_cuda_screened_cuda_dist_logits_match_plain(cuda):
    """``screened-cuda.dist_logits`` on the card (route and gather kernels)
    against its plain version on the CPU, at V = 600 (a padded last tile):
    values within 1e-5, the same finite support, equal to the routed
    cluster's candidate words < V, and every sampled id inside it."""
    from repro_torch.heads import ScreenedCudaHead
    from repro_torch.heads.base import NEG_INF as H_NEG_INF
    eng, _ = _graph_engine(cuda, "lstm")
    hd = eng.resolve_head("screened-cuda")
    g = torch.Generator().manual_seed(3)
    h = torch.randn((40, eng.W.shape[1]), generator=g).cuda()
    ops.reset_launches()
    got = hd.dist_logits(h)
    assert ops.LAUNCHES["cluster_route"] == 1
    assert ops.LAUNCHES["screened_logits"] == 1
    scr = eng.screen
    plain = ScreenedCudaHead(eng.W.cpu(), eng.b.cpu(),
                             scr.to("cpu")).dist_logits(h.cpu())
    on = got > H_NEG_INF / 2
    assert torch.equal(on.cpu(), plain > H_NEG_INF / 2)
    torch.testing.assert_close(torch.where(on, got, 0.0).cpu(),
                               torch.where(plain > H_NEG_INF / 2, plain, 0.0),
                               **TOL)
    cluster = cluster_route(h, scr.v).long()
    blocks = scr.cand_idx[cluster]
    words = torch.zeros_like(on)
    n_blk = -(-eng.W.shape[0] // V_BLK)
    for i in range(h.shape[0]):
        for blk in blocks[i].tolist():
            if blk < n_blk:
                words[i, blk * V_BLK:(blk + 1) * V_BLK] = True
    assert torch.equal(on, words)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = torch.arange(h.shape[0], device="cuda")
    for top_p in (1.0, 0.9):
        for _ in range(10):
            ids = hd.sample(h, 1.0, top_p, generator=gen).long()
            assert on[rows, ids].all()


def test_cuda_paged_lstm_stream_matches_a_plain_stream(cuda):
    """A paged LSTM stream (shared prompt prefixes, resumed prefill from
    radix snapshots) gives a plain stream's tokens bit for bit on the
    card, and reuses the plain stream's graph."""
    from repro_torch.serving import PagePool, ServeRequest
    eng, prompts = _graph_engine(cuda, "lstm")
    base = prompts[0][:16]
    reqs = [ServeRequest(prompt=np.concatenate([base, prompts[1][:3 + i]]),
                         max_new=6) for i in range(6)]

    def run(stream):
        done, pending = {}, list(enumerate(reqs))
        while pending or stream.n_active:
            while pending and stream.free_slots:
                i, r = pending.pop(0)
                stream.join(r, tag=i)
            done.update({t: toks.tolist() for t, _, toks in stream.step()})
        return done
    want = run(eng.open_stream("screened-cuda", width=3))
    pool = PagePool(64, 8)
    got = run(eng.open_paged_stream(pool, head="screened-cuda", width=3))
    assert got == want
    assert pool.radix.tokens_hit >= 5 * 16
    assert eng.compiled_step_counts() == {("screened-cuda", "greedy"): 1}


# -- the SSD backward kernel and SSM / hybrid training ---------------------------

def _ssd_grad_inputs(cuda, B, nc, Q, H, P, G, N, seed):
    g = torch.Generator().manual_seed(seed)
    xw = torch.randn((B, nc, Q, H, P), generator=g)
    Bm = torch.randn((B, nc, Q, G, N), generator=g)
    Cm = torch.randn((B, nc, Q, G, N), generator=g)
    l = -torch.cumsum(torch.rand((B, nc, Q, H), generator=g) * 0.05, dim=2)
    dy = torch.randn((B, nc, Q, H, P), generator=g)
    dS = torch.randn((B, nc, H, N, P), generator=g)
    return [a.to(cuda) for a in (xw, Bm, Cm, l, dy, dS)]


@pytest.mark.parametrize("B,nc,Q,H,P,G,N", [
    (2, 2, 256, 8, 64, 1, 64),        # zamba2's chunk, fewer heads
    (1, 2, 256, 8, 64, 1, 128),       # mamba2's N = 128: two n slices
    (2, 1, 100, 4, 72, 2, 20),        # G = 2, a ragged P (two p slices)
    (3, 1, 7, 6, 8, 2, 16),           # a short, odd chunk
    (1, 2, 65, 4, 64, 1, 128),        # Q = 65: a one-row last tile
    (2, 1, 1, 4, 64, 1, 64),          # Q = 1
    (1, 1, 70, 3, 10, 3, 6),          # P, N not multiples of 4
    (1, 2, 256, 4, 64, 2, 128),       # mamba2's N = 128 with G = 2
    (1, 1, 256, 2, 128, 1, 128),      # P = N = 128: one whole block
    (1, 1, 130, 2, 192, 1, 40),       # P = 192: two 128-wide p slices
    (1, 1, 70, 2, 36, 1, 160),        # N = 160: two 128-wide n slices
])
def test_cuda_ssd_intra_bwd_matches_plain(cuda, B, nc, Q, H, P, G, N):
    """The backward kernel against ``ssd_intra_bwd_plain`` on the card:
    each of dxw, dB, dC and dl within 1e-4 of its largest magnitude; a
    second launch gives the same bits (no atomics)."""
    _check_ssd_bwd(_ssd_grad_inputs(cuda, B, nc, Q, H, P, G, N, Q + N + P))


@pytest.mark.parametrize("H,P,G,N", [(2, 64, 1, 64), (4, 64, 2, 128)])
def test_cuda_ssd_intra_bwd_wide_range(cuda, H, P, G, N):
    """The same at Q = 256 on the inputs of the CPU precision test's wide
    case (``test_torch_train_ssm.py::test_split_tf32_precision``): |l|
    differences up to 30, so that E spans many decades, and inputs scaled
    by 1e3."""
    Q = 256
    rng = np.random.default_rng(N + G + 10)
    f32 = np.float32
    xw, Bm, Cm = (rng.standard_normal(s).astype(f32) * f32(1e3)
                  for s in ((1, 1, Q, H, P), (1, 1, Q, G, N), (1, 1, Q, G, N)))
    l = (-np.cumsum(rng.uniform(0.0, 60.0 / Q, (1, 1, Q, H)), axis=2)).astype(f32)
    dy = rng.standard_normal((1, 1, Q, H, P)).astype(f32) * f32(1e3)
    dS = rng.standard_normal((1, 1, H, N, P)).astype(f32) * f32(1e3)
    _check_ssd_bwd([torch.from_numpy(a).to(cuda)
                    for a in (xw, Bm, Cm, l, dy, dS)])


def _check_ssd_bwd(args):
    from repro_torch.kernels.ssd import ssd_intra_bwd, ssd_intra_bwd_plain
    ops.reset_launches()
    got = ssd_intra_bwd(*args)
    again = ssd_intra_bwd(*args)
    want = ssd_intra_bwd_plain(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_intra_bwd"] == 2
    for a, b, w in zip(got, again, want):
        assert a.shape == w.shape and torch.equal(a, b)
        # (at Q = 1, dl is 0 on both sides: its terms cancel exactly)
        scale = max(float(w.abs().max()), 1e-30)
        assert float((a - w).abs().max()) / scale <= 1e-4


def test_cuda_ssd_intra_autograd_runs_both_kernels(cuda):
    """``ssd_intra`` under autograd on the card: one forward and one
    backward launch, and the gradients those of the plain version."""
    from repro_torch.kernels.ssd import ssd_intra, ssd_intra_plain
    xw, Bm, Cm, l, dy, dS = _ssd_grad_inputs(cuda, 2, 2, 64, 4, 16, 2, 8, 5)
    grads = {}
    for name, fn in (("kernel", ssd_intra), ("plain", ssd_intra_plain)):
        ins = [a.clone().requires_grad_(True) for a in (xw, Bm, Cm, l)]
        ops.reset_launches()
        y, S = fn(*ins)
        grads[name] = torch.autograd.grad((y * dy).sum() + (S * dS).sum(), ins)
        if name == "kernel":
            assert ops.LAUNCHES["ssd_intra"] == 1
            assert ops.LAUNCHES["ssd_intra_bwd"] == 1
    for a, w in zip(grads["kernel"], grads["plain"]):
        assert float((a - w).abs().max() / w.abs().max()) <= 1e-4


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-1.3b"])
def test_cuda_ssm_train_step_matches_the_cpu(cuda, arch):
    """One train step of the reduced model on the card against the same
    step on the CPU (gradients within 1e-4 of the largest |g|, loss within
    1e-5 relative); remat on and off give the card bit-identical
    gradients; then four AdamW steps on one batch lower its loss."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import ZipfMarkovCorpus, make_lm_batches
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import Model
    from repro_torch.models.model import to_device
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_flatten

    cfg = get_config(arch).reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu",
                        dtype=torch.float32)
    corpus = ZipfMarkovCorpus(cfg.vocab_size, branching=16, seed=0)
    batches = [{k: torch.as_tensor(x) for k, x in b.items()}
               for b in make_lm_batches(corpus, 1, 2, 40, seed=2)]
    got = {}
    for dev, remat in (("cpu", "none"), (cuda, "none"), (cuda, "block")):
        tcfg = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=4,
                           remat=remat, loss_chunk=None)
        ops.reset_launches()
        loss, grads = loss_and_grads(model, tcfg, to_device(params, dev), {
            k: x.to(dev) for k, x in batches[0].items()})
        if dev != "cpu":
            assert ops.LAUNCHES["ssd_intra_bwd"] == cfg.num_layers
        got[(str(dev), remat)] = (float(loss),
                                  [g.cpu() for g in tree_flatten(grads)])
    cpu, card = got[("cpu", "none")], got[(str(cuda), "none")]
    gmax = max(float(g.abs().max()) for g in cpu[1])
    for a, c in zip(card[1], cpu[1]):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-4 * gmax)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)
    remat = got[(str(cuda), "block")]
    assert remat[0] == card[0]
    assert all(torch.equal(a, b) for a, b in zip(remat[1], card[1]))

    step = make_train_step(model, TrainConfig(
        lr=3e-3, warmup_steps=1, total_steps=4, remat="block",
        loss_chunk=None), donate=True)
    p = to_device(params, cuda)
    opt = adamw_init(p)
    batch = {k: x.to(cuda) for k, x in batches[0].items()}
    losses = []
    for _ in range(4):
        p, opt, m = step(p, opt, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# -- the dense family's shapes (gemma-2b, smollm-360m, starcoder2-3b,
#    qwen1.5-110b) -------------------------------------------------------------

@pytest.mark.parametrize("KV,hd", [(1, 256), (5, 64), (2, 128)])
def test_cuda_cache_kv_update_at_the_dense_shapes(cuda, KV, hd):
    """The K/V pair in bf16 at gemma-2b's MQA rows (512 bytes),
    smollm-360m's (640) and starcoder2-3b's (512): bit for bit, per-row
    slots and one slot for every row."""
    from repro_torch.kernels.cache_update import (cache_kv_update,
                                                  cache_slot_update_plain)
    g = torch.Generator().manual_seed(KV * hd)
    B, S = 4, 544
    ck, cv = (torch.randn((B, S, KV, hd), generator=g).to(cuda, torch.bfloat16)
              for _ in range(2))
    uk, uv = (torch.randn((B, KV, hd), generator=g).to(cuda, torch.bfloat16)
              for _ in range(2))
    for slot in (0, S - 1, S + 3, torch.tensor([5, 511, S + 2, -1],
                                               dtype=torch.int32,
                                               device=cuda)):
        ops.reset_launches()
        gk, gv = cache_kv_update(ck.clone(), uk, cv.clone(), uv, slot)
        assert ops.LAUNCHES["cache_slot_update"] == 1
        assert torch.equal(gk, cache_slot_update_plain(ck.clone(), uk, slot))
        assert torch.equal(gv, cache_slot_update_plain(cv.clone(), uv, slot))


@pytest.fixture(scope="module")
def gemma_head():
    """gemma-2b's softmax head in bf16 (V = 256,000 → 2,000 tiles of
    d = 2048), drawn on the card, with a float32 v of 100 clusters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(11)
    W = (torch.randn((256_000, 2048), generator=g, device="cuda") * 0.05)
    b = torch.randn((256_000,), generator=g, device="cuda") * 0.1
    Wb, bb = ops.pack_head_blocks(W.to(torch.bfloat16), b.to(torch.bfloat16))
    v = torch.randn((100, 2048), generator=g, device="cuda")
    return Wb, bb, v


@pytest.mark.parametrize("k", [1, 5, 128])
def test_cuda_bf16_kernels_at_gemma_shapes(cuda, gemma_head, k):
    """Route, gather and fused (bf16 bodies) at d = 2048 over 2,000 tiles,
    B = 4, K = 16 (some slots sentinel): routes equal, logits, values and
    logZ within 1e-5 of the plain versions; fused == unfused bit for bit."""
    Wb, bb, v = gemma_head
    n_blk = Wb.shape[0]
    assert n_blk == 2000
    g = torch.Generator().manual_seed(k)
    B, K = 4, 16
    h = torch.randn((B, 2048), generator=g).to(cuda, torch.bfloat16)
    ids = torch.randint(0, n_blk + 2, (B, K), generator=g,
                        dtype=torch.int32).to(cuda)
    assert torch.equal(cluster_route(h, v), cluster_route_plain(h, v))
    raw = screened_logits(Wb, bb, h, ids)
    torch.testing.assert_close(raw, screened_logits_plain(Wb, bb, h, ids),
                               **TOL)
    valid = ((ids >= 0) & (ids < n_blk))[..., None]
    row = torch.where(valid, raw, NEG_INF).reshape(B, -1)
    lane = torch.arange(V_BLK, device=cuda, dtype=torch.int32)
    word = torch.where(valid, ids[..., None] * V_BLK + lane,
                       n_blk * V_BLK).reshape(B, -1)
    ki, kv, kz = fused_screened_topk(Wb, bb, h, ids, k=k)
    pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k)
    torch.testing.assert_close(kv, pv, **TOL)
    torch.testing.assert_close(kz, pz, **TOL)
    uv, upos = topk_desc(row, k)
    assert torch.equal(kv, uv) and torch.equal(ki, torch.gather(word, 1, upos))


@pytest.mark.parametrize("B", [1, 4, 130])
def test_cuda_cluster_route_at_d8192(cuda, B):
    """qwen1.5-110b's d = 8192 (4 rows of h a thread block cluster): routes
    equal the plain argmax but where the plain top-2 scores lie within
    1e-5 relative, in float32 and from a bf16 h; and an exact tie across
    the blocks of the cluster goes to the first index."""
    g = torch.Generator().manual_seed(B)
    d, r = 8192, 100
    h = torch.randn((B, d), generator=g).to(cuda)
    v = torch.randn((r, d), generator=g).to(cuda)
    for hh in (h, h.to(torch.bfloat16)):
        got, want = cluster_route(hh, v), cluster_route_plain(hh, v)
        scores = hh.float() @ v.T
        s_got = scores.gather(1, got.long()[:, None])[:, 0]
        s_want = scores.gather(1, want.long()[:, None])[:, 0]
        diff = got != want
        rel = (s_got - s_want).abs() / s_want.abs().clamp_min(1e-30)
        assert bool((rel[diff] < 1e-5).all()), (int(diff.sum()), rel[diff])
    v = torch.round(torch.randn((r, d), generator=g) * 2) / 2
    v[3] = v[50] = v[99] = 4.0
    h = torch.round(torch.rand((B, d), generator=g) * 3) * 0.5 + 0.5
    h, v = h.to(cuda), v.to(cuda)
    assert bool((cluster_route_plain(h, v) == 3).all())
    assert bool((cluster_route(h, v) == 3).all())


def test_cuda_gather_and_fused_at_d8192(cuda):
    """The gather and fused kernels take d = 8192 too (the fused merge asks
    for 33 KB of shared memory there): bf16 head of 200 tiles, B = 4,
    K = 16, against the plain versions; fused == unfused bit for bit."""
    Wb, bb, h, ids, _ = _bf16_inputs(cuda, 8192, 25_600, 4, 16, seed=3)
    n_blk = Wb.shape[0]
    raw = screened_logits(Wb, bb, h, ids)
    torch.testing.assert_close(raw, screened_logits_plain(Wb, bb, h, ids),
                               **TOL)
    valid = ((ids >= 0) & (ids < n_blk))[..., None]
    row = torch.where(valid, raw, NEG_INF).reshape(4, -1)
    for k in (1, 5):
        _, kv, kz = fused_screened_topk(Wb, bb, h, ids, k=k)
        _, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k)
        torch.testing.assert_close(kv, pv, **TOL)
        torch.testing.assert_close(kz, pz, **TOL)
        assert torch.equal(kv, topk_desc(row, k)[0])


def test_cuda_dense_paged_stream_matches_a_plain_stream(cuda):
    """gemma-2b at full width, cut to 2 layers, in bf16: a width-3 paged
    stream (pages of 16, requests sharing a 32-token prefix, prompts of
    one length: a prefill's rows can differ in their last bits between
    prompt lengths on the card) gives a plain stream's tokens bit for bit
    through screened-cuda, on the paged step's graph, and the contiguous
    decode launches the cache pair."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core.screening import ScreenParams
    from repro_torch.models import Model
    from repro_torch.serving import DecodeEngine, PagePool, ServeRequest
    cfg = replace(get_config("gemma-2b"), num_layers=2)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    n_blk = cfg.vocab_size // V_BLK
    cand = np.sort(rng.choice(n_blk, (8, 16)), axis=1).astype(np.int32)
    screen = ScreenParams(
        v=torch.randn((8, cfg.d_model), device=cuda),
        cand_idx=torch.as_tensor(cand, device=cuda),
        cand_len=torch.full((8,), 16, dtype=torch.int32, device=cuda),
        vocab_size=cfg.vocab_size, block=V_BLK)
    eng = DecodeEngine(model, params, screen=screen, max_len=64,
                       cache_dtype=torch.bfloat16, device=cuda)
    base = rng.integers(0, cfg.vocab_size, 32)
    reqs = [ServeRequest(prompt=np.concatenate(
        [base, rng.integers(0, cfg.vocab_size, 7)]).astype(np.int32),
        max_new=8) for i in range(5)]

    def run(stream):
        done, pending = {}, list(enumerate(reqs))
        while pending or stream.n_active:
            while pending and stream.free_slots:
                i, r = pending.pop(0)
                stream.join(r, tag=i)
            done.update({t: toks.tolist() for t, _, toks in stream.step()})
        return done
    ops.reset_launches()
    want = run(eng.open_stream("screened-cuda", width=3))
    assert ops.LAUNCHES["cache_slot_update"] > 0
    pool = PagePool(32, 16)
    got = run(eng.open_paged_stream(pool, head="screened-cuda", width=3))
    assert got == want
    assert pool.radix.tokens_hit >= 4 * 32
    assert eng.compiled_step_counts() == {("screened-cuda", "greedy"): 1,
                                          ("screened-cuda", "greedy-paged"): 1}


# -- the moe family's shapes (mixtral-8x7b, phi3.5-moe-42b-a6.6b) and the
#    sliding-window ring cache --------------------------------------------------

def test_cuda_cache_kv_update_at_ring_slots(cuda):
    """mixtral-8x7b's ring of 4,096 slots (KV 8, hd 128, bf16): per-row
    positions that wrap (slot pos % S, wrapped on the device) write what
    the plain version writes, bit for bit; ``attn_decode`` on a ring with a
    tensor position equals the int path bit for bit, past the wrap."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.cache_update import (cache_kv_update,
                                                  cache_slot_update_plain)
    from repro_torch.layers import attention
    g = torch.Generator().manual_seed(40)
    B, S, KV, hd = 4, 4096, 8, 128
    ck, cv = (torch.randn((B, S, KV, hd), generator=g).to(cuda, torch.bfloat16)
              for _ in range(2))
    uk, uv = (torch.randn((B, KV, hd), generator=g).to(cuda, torch.bfloat16)
              for _ in range(2))
    pos = torch.tensor([4095, 4096, 8191, 5000], dtype=torch.int32,
                       device=cuda)
    slot = torch.remainder(pos, S)
    ops.reset_launches()
    gk, gv = cache_kv_update(ck.clone(), uk, cv.clone(), uv, slot)
    assert ops.LAUNCHES["cache_slot_update"] == 1
    assert torch.equal(gk, cache_slot_update_plain(ck.clone(), uk, slot))
    assert torch.equal(gv, cache_slot_update_plain(cv.clone(), uv, slot))
    cfg = replace(get_config("mixtral-8x7b").reduced(), sliding_window=8)
    p = attention.attn_init(torch.Generator().manual_seed(41), cfg)
    p = {k: t.to(cuda) for k, t in p.items()}
    x = torch.randn((2, 20, cfg.d_model), generator=g).to(cuda)
    ci = attention.init_cache(cfg, 2, 20, window=8, device=cuda)
    ct = attention.init_cache(cfg, 2, 20, window=8, device=cuda)
    for t in range(20):
        oi, _ = attention.attn_decode(p, x[:, t:t + 1], ci, t, cfg)
        ot, _ = attention.attn_decode(p, x[:, t:t + 1], ct, torch.full(
            (2,), t, dtype=torch.int32, device=cuda), cfg)
        assert torch.equal(oi, ot)
    assert torch.equal(ci["k"], ct["k"]) and torch.equal(ci["v"], ct["v"])


@pytest.fixture(scope="module", params=[32_000, 32_064],
                ids=["mixtral-250-tiles", "phi-251-tiles"])
def moe_head(request):
    """mixtral-8x7b's (V = 32,000: 250 tiles) or phi3.5-moe's (V = 32,064:
    251 tiles, the last holding 64 words) bf16 head at d = 4096."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(12)
    L, d = request.param, 4096
    W = torch.randn((L, d), generator=g, device="cuda") * 0.05
    b = torch.randn((L,), generator=g, device="cuda") * 0.1
    Wb, bb = ops.pack_head_blocks(W.to(torch.bfloat16), b.to(torch.bfloat16))
    v = torch.randn((100, d), generator=g, device="cuda")
    return L, Wb, bb, v


@pytest.mark.parametrize("k", [1, 5, 128])
def test_cuda_bf16_kernels_at_moe_shapes(cuda, moe_head, k):
    """Route, gather and fused (bf16 bodies) at d = 4096 over 250 or 251
    tiles, B = 4, K = 16, with the last tile (phi's partial one) in every
    row and some slots sentinel: routes equal, logits, values and logZ
    within 1e-5 of the plain versions, fused == unfused bit for bit, and no
    padded word (id ≥ V) among the top-k."""
    L, Wb, bb, v = moe_head
    n_blk = Wb.shape[0]
    assert n_blk == -(-L // V_BLK)
    g = torch.Generator().manual_seed(k)
    B, K = 4, 16
    h = torch.randn((B, 4096), generator=g).to(cuda, torch.bfloat16)
    ids = torch.randint(0, n_blk + 2, (B, K), generator=g, dtype=torch.int32)
    ids[:, 0] = n_blk - 1
    ids = ids.to(cuda)
    assert torch.equal(cluster_route(h, v), cluster_route_plain(h, v))
    raw = screened_logits(Wb, bb, h, ids)
    torch.testing.assert_close(raw, screened_logits_plain(Wb, bb, h, ids),
                               **TOL)
    valid = ((ids >= 0) & (ids < n_blk))[..., None]
    row = torch.where(valid, raw, NEG_INF).reshape(B, -1)
    lane = torch.arange(V_BLK, device=cuda, dtype=torch.int32)
    word = torch.where(valid, ids[..., None] * V_BLK + lane,
                       n_blk * V_BLK).reshape(B, -1)
    ki, kv, kz = fused_screened_topk(Wb, bb, h, ids, k=k)
    pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k)
    torch.testing.assert_close(kv, pv, **TOL)
    torch.testing.assert_close(kz, pz, **TOL)
    uv, upos = topk_desc(row, k)
    assert torch.equal(kv, uv) and torch.equal(ki, torch.gather(word, 1, upos))
    assert bool((ki < L).all())


def _reduced_mixtral():
    """Reduced mixtral-8x7b (window 64, 4 experts) in float32 on the CPU
    from a CPU generator, its lm_head × 20 (greedy steps decided far above
    float32 rounding), and a random 128-word block screen."""
    from repro_torch.configs import get_config
    from repro_torch.core.screening import ScreenParams
    from repro_torch.models import Model
    cfg = get_config("mixtral-8x7b").reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(42), device="cpu",
                        dtype=torch.float32)
    params["embed"]["lm_head"] *= 20.0
    screen = ScreenParams(
        v=torch.randn((4, cfg.d_model),
                      generator=torch.Generator().manual_seed(43)) * 3,
        cand_idx=torch.tensor([[0, 3], [1, 2], [0, 1], [1, 3]],
                              dtype=torch.int32),
        cand_len=torch.full((4,), 2, dtype=torch.int32),
        vocab_size=cfg.vocab_size, block=V_BLK)
    return model, params, screen


def test_cuda_mixtral_ring_decode_and_spec_rollback_match_the_cpu(cuda):
    """Reduced mixtral: ring decode over 3× its 64-slot window on the card
    against the CPU (hidden states within 1e-4 of max |h|); a width-3
    SpecDecodeStream (the random screen drafting, exact verifying) whose
    rounds cross the wrap gives the plain exact tokens on the card, and the
    CPU's."""
    from repro_torch.models.model import to_device
    from repro_torch.serving import DecodeEngine, ServeRequest
    model, cpu_params, screen = _reduced_mixtral()
    params = to_device(cpu_params, cuda)
    toks = np.random.default_rng(44).integers(0, 512, (2, 192))
    hs = {}
    for dev, p in (("cpu", cpu_params), (cuda, params)):
        with torch.inference_mode():
            cache = model.init_cache(2, 16, dtype=torch.float32, device=dev)
            t = torch.as_tensor(toks, device=dev)
            h, _ = model.prefill(p, {"tokens": t[:, :8]}, cache)
            out = [h[:, -1]]
            for i in range(8, 192):
                h1, _ = model.decode_step(p, t[:, i], cache, i)
                out.append(h1)
        hs[str(dev)] = torch.stack(out, 1).cpu()
    want = hs["cpu"]
    assert float((hs[str(cuda)] - want).abs().max()) <= \
        1e-4 * float(want.abs().max())
    ps = np.random.default_rng(45).integers(0, 512, (3, 12))
    reqs = [ServeRequest(prompt=p, max_new=60) for p in ps]
    got = {}
    for dev, p in (("cpu", cpu_params), (cuda, params)):
        eng = DecodeEngine(model, p, screen=screen.to(dev), max_len=80,
                           device=dev)
        s = eng.open_spec_stream("screened-cuda", "exact", width=3,
                                 draft_len=4)
        for i, r in enumerate(reqs):
            s.join(r, tag=i)
        done = {}
        while not s.idle:
            done.update({t: toks_.tolist() for t, _, toks_ in s.step()})
        assert s.restored_rows > 0
        base = eng.generate(ps, 60, head="exact").tokens
        assert all(done[i] == base[i].tolist() for i in range(3))
        got[str(dev)] = done
    assert got["cpu"] == got[str(cuda)]


@pytest.fixture(scope="module")
def qwen2vl_head():
    """qwen2-vl-2b's bf16 head (V = 151,936 → 1,187 tiles of d = 1536),
    drawn on the card, with a float32 v of 100 clusters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(13)
    W = torch.randn((151_936, 1536), generator=g, device="cuda") * 0.05
    b = torch.randn((151_936,), generator=g, device="cuda") * 0.1
    Wb, bb = ops.pack_head_blocks(W.to(torch.bfloat16), b.to(torch.bfloat16))
    v = torch.randn((100, 1536), generator=g, device="cuda")
    return Wb, bb, v


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("k", [1, 5, 128])
def test_cuda_bf16_kernels_at_qwen2vl_shapes(cuda, qwen2vl_head, B, k):
    """Route, gather and fused (bf16 bodies) at d = 1536 over 1,187 tiles,
    K = 16 (some slots sentinel): routes equal but near-ties, logits,
    values and logZ within 1e-5 of the plain versions; fused == unfused bit
    for bit."""
    Wb, bb, v = qwen2vl_head
    n_blk = Wb.shape[0]
    assert n_blk == 1187
    g = torch.Generator().manual_seed(100 * B + k)
    h = torch.randn((B, 1536), generator=g).to(cuda, torch.bfloat16)
    got, want = cluster_route(h, v), cluster_route_plain(h, v)
    scores = h.float() @ v.T
    diff = got != want
    s_got = scores.gather(1, got.long()[:, None])[:, 0]
    s_want = scores.gather(1, want.long()[:, None])[:, 0]
    assert bool(((s_got - s_want).abs()[diff] <
                 1e-5 * s_want.abs()[diff]).all())
    ids = torch.randint(0, n_blk + 2, (B, 16), generator=g,
                        dtype=torch.int32).to(cuda)
    raw = screened_logits(Wb, bb, h, ids)
    torch.testing.assert_close(raw, screened_logits_plain(Wb, bb, h, ids),
                               **TOL)
    valid = ((ids >= 0) & (ids < n_blk))[..., None]
    row = torch.where(valid, raw, NEG_INF).reshape(B, -1)
    lane = torch.arange(V_BLK, device=cuda, dtype=torch.int32)
    word = torch.where(valid, ids[..., None] * V_BLK + lane,
                       n_blk * V_BLK).reshape(B, -1)
    ki, kv, kz = fused_screened_topk(Wb, bb, h, ids, k=k)
    pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k)
    torch.testing.assert_close(kv, pv, **TOL)
    torch.testing.assert_close(kz, pz, **TOL)
    uv, upos = topk_desc(row, k)
    assert torch.equal(kv, uv) and torch.equal(ki, torch.gather(word, 1, upos))


def test_cuda_route_tie_at_d1536(cuda):
    """An exact tie across the blocks of the route's cluster at qwen2-vl's
    d = 1536 goes to the first index, from a bf16 h."""
    g = torch.Generator().manual_seed(14)
    v = torch.round(torch.randn((100, 1536), generator=g) * 2) / 2
    v[3] = v[50] = v[99] = 4.0
    h = torch.round(torch.rand((4, 1536), generator=g) * 3) * 0.5 + 0.5
    h, v = h.to(cuda, torch.bfloat16), v.to(cuda)
    assert bool((cluster_route_plain(h, v) == 3).all())
    assert bool((cluster_route(h, v) == 3).all())


def test_cuda_cache_kv_update_at_qwen2vl_cache(cuda):
    """The K/V pair at qwen2-vl-2b's decode cache (4, 544, 2, 128) bf16
    (256 patches + 256 tokens + 32 new): bit for bit, one launch."""
    from repro_torch.kernels.cache_update import (cache_kv_update,
                                                  cache_slot_update_plain)
    g = torch.Generator().manual_seed(15)
    B, S = 4, 544
    ck, cv = (torch.randn((B, S, 2, 128), generator=g).to(cuda, torch.bfloat16)
              for _ in range(2))
    uk, uv = (torch.randn((B, 2, 128), generator=g).to(cuda, torch.bfloat16)
              for _ in range(2))
    for slot in (512, S - 1, S + 3, torch.tensor([512, 519, S - 1, 0],
                                                 dtype=torch.int32,
                                                 device=cuda)):
        ops.reset_launches()
        gk, gv = cache_kv_update(ck.clone(), uk, cv.clone(), uv, slot)
        assert ops.LAUNCHES["cache_slot_update"] == 1
        assert torch.equal(gk, cache_slot_update_plain(ck.clone(), uk, slot))
        assert torch.equal(gv, cache_slot_update_plain(cv.clone(), uv, slot))


def test_cuda_reduced_vlm_decode_and_audio_match_the_cpu(cuda):
    """Reduced qwen2-vl (M-RoPE over 8 patches): prefill and 8 decode
    steps at pos P + T + j on the card against the CPU (hidden states
    within 1e-4 of max |h|), the cache pair launched once a layer a step;
    reduced hubert-xlarge with bf16 weights and float32 frames: float32 h
    on both, within 1e-4 of max |h|."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import to_device
    cfg = get_config("qwen2-vl-2b").reduced()
    model = Model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(16), device="cpu")
    rng = np.random.default_rng(16)
    toks = rng.integers(0, 512, (2, 20))
    patches = rng.standard_normal((2, 8, 128)).astype(np.float32)
    hs = {}
    for dev, p in (("cpu", cpu_params), (cuda, to_device(cpu_params, cuda))):
        ops.reset_launches()
        with torch.inference_mode():
            cache = model.init_cache(2, 8 + 12 + 8, dtype=torch.float32,
                                     device=dev)
            t = torch.as_tensor(toks, device=dev)
            h, _ = model.prefill(p, {"tokens": t[:, :12], "patches":
                                     torch.as_tensor(patches, device=dev)},
                                 cache)
            out = [h[:, -1]]
            for i in range(12, 20):
                h1, _ = model.decode_step(p, t[:, i], cache, 8 + i)
                out.append(h1)
        hs[str(dev)] = torch.stack(out, 1).cpu()
        if dev != "cpu":
            assert ops.LAUNCHES["cache_slot_update"] == cfg.num_layers * 8
    want = hs["cpu"]
    assert float((hs[str(cuda)] - want).abs().max()) <= \
        1e-4 * float(want.abs().max())
    acfg = replace(get_config("hubert-xlarge").reduced(), dtype="bfloat16")
    am = Model(acfg)
    ap = am.init(torch.Generator().manual_seed(17), device="cpu")
    fr = torch.as_tensor(rng.standard_normal((2, 40, 128)).astype(np.float32))
    with torch.inference_mode():
        a_cpu, _ = am.forward(ap, {"frames": fr})
        a_gpu, _ = am.forward(to_device(ap, cuda), {"frames": fr.to(cuda)})
    assert a_cpu.dtype == a_gpu.dtype == torch.float32
    assert float((a_gpu.cpu() - a_cpu).abs().max()) <= \
        1e-4 * float(a_cpu.abs().max())


# -- the vocab-sharded heads ------------------------------------------------------

def _sharded_inputs(cuda, L=1500, d=128, r=6, K=5, B=8, seed=26):
    """A vocabulary that 8 shards of 256 rows over-cover (shards 6 and 7
    own nothing) and a block screen of K of its 12 tiles a cluster."""
    from repro_torch.core.screening import candidates_to_padded
    from repro_torch.interop import screen_from_numpy
    rng = np.random.default_rng(seed)
    W = torch.as_tensor(rng.standard_normal((L, d)).astype(np.float32) * 0.1)
    b = torch.as_tensor(rng.standard_normal(L).astype(np.float32) * 0.1)
    h = torch.as_tensor(rng.standard_normal((B, d)).astype(np.float32))
    n_blk = -(-L // V_BLK)
    mask = np.zeros((r, n_blk), bool)
    for t in range(r):
        mask[t, rng.choice(n_blk, K, replace=False)] = True
    idx, lens = candidates_to_padded(mask, L, block=V_BLK)
    screen = screen_from_numpy(rng.standard_normal((r, d)) * 3, idx, lens, L,
                               V_BLK)
    return W.to(cuda), b.to(cuda), h.to(cuda), screen.to(cuda)


@pytest.mark.parametrize("k", [1, 5, 300])
def test_cuda_sharded_fused_per_shard_launch_matches_plain(cuda, k):
    """screened-sharded local="cuda" over 8 shards: each shard's launch
    (local block ids; shards 6 and 7 all sentinel; k = 300 above one
    shard's 2·128 slots, clipped) against the plain version on the same
    inputs, and the head's ids equal screened-cuda's and the CPU head's."""
    from repro_torch import heads
    W, b, h, screen = _sharded_inputs(cuda)
    hd = heads.get("screened-sharded", device=cuda, W=W, b=b, screen=screen,
                   n_shards=8, local="cuda")
    nbs = hd.Ls // V_BLK
    assert (hd.Ls, nbs) == (256, 2)
    cluster = torch.argmax(h @ screen.v.T, dim=-1)
    for s, (Ws, bs, _, blocks) in enumerate(hd.slabs):
        ids = blocks[cluster].contiguous()
        assert bool((ids == nbs).all()) == (s >= 6)
        kk = min(k, ids.shape[-1] * V_BLK)
        args = (Ws.view(nbs, V_BLK, -1), bs.view(nbs, V_BLK), h, ids)
        ops.reset_launches()
        ki, kv, kz = fused_screened_topk(*args, k=kk)
        assert ops.LAUNCHES["fused_screened_topk"] == 1
        pi, pv, pz = fused_screened_topk_plain(*args, kk)
        assert torch.equal(ki, pi)
        torch.testing.assert_close(kv, pv, **TOL)
        torch.testing.assert_close(kz, pz, **TOL)
    kb = min(k, screen.c_max * V_BLK)
    ops.reset_launches()
    got = hd.topk_logprobs(h, kb)
    assert ops.LAUNCHES["fused_screened_topk"] == 8
    want = heads.get("screened-cuda", device=cuda, W=W, b=b,
                     screen=screen).topk_logprobs(h, kb)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], **TOL)
    cpu = heads.get("screened-sharded", device="cpu", W=W.cpu(), b=b.cpu(),
                    screen=screen.to("cpu"), n_shards=8, local="cuda")
    assert torch.equal(got[0].cpu(), cpu.topk_logprobs(h.cpu(), kb)[0])


SHARDED_GRAPH_HEADS = ["exact-sharded", "screened-sharded", "adaptive-sharded"]


@pytest.mark.parametrize("name", SHARDED_GRAPH_HEADS)
def test_cuda_graph_with_a_sharded_head(cuda, name):
    """An 8-shard head through the engine's graphs: greedy and beam tokens
    equal its eager step bodies and its unsharded twin's; one graph per
    (head, kind); a second call adds none; a replay counts the launches
    the eager run makes (8 fused launches a step for local="cuda", 1 + 8
    for adaptive-sharded)."""
    from repro_torch import heads
    from repro_torch.testing import eager_beam_search, eager_generate
    eng, prompts = _graph_engine(cuda, "lstm")
    kw = dict(device=cuda, W=eng.W, b=eng.b, n_shards=8)
    twin = {"exact-sharded": eng.resolve_head("exact"),
            "screened-sharded": eng.resolve_head("screened-cuda"),
            "adaptive-sharded": _head(eng, "adaptive-fused")}[name]
    if name == "screened-sharded":
        kw.update(screen=eng.screen, local="cuda")
    if name == "adaptive-sharded":
        kw.update(shortlist=200, n_tails=2)
    hd = heads.get(name, **kw)
    eng.generate(prompts, 6, head=hd)                      # capture
    counts = eng.compiled_step_counts()
    ops.reset_launches()
    got = eng.generate(prompts, 6, head=hd)
    replayed = dict(ops.LAUNCHES)
    ops.reset_launches()
    want = eager_generate(eng, prompts, 6, head=hd)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert replayed == ops.LAUNCHES
    per_step = {"exact-sharded": 0, "screened-sharded": 8,
                "adaptive-sharded": 9}[name]
    assert replayed["fused_screened_topk"] == per_step * 6
    np.testing.assert_array_equal(
        got.tokens, eng.generate(prompts, 6, head=twin).tokens)
    gb = eng.beam_search(prompts[0], 4, 6, head=hd)
    eb = eager_beam_search(eng, prompts[0], 4, 6, head=hd)
    np.testing.assert_array_equal(gb.tokens, eb.tokens)
    np.testing.assert_array_equal(
        gb.tokens, eng.beam_search(prompts[0], 4, 6, head=twin).tokens)
    assert counts[(name, "greedy")] == 1
    assert eng.compiled_step_counts()[(name, "decode")] == 1
    eng.generate(prompts, 6, head=hd)
    assert eng.compiled_step_counts()[(name, "greedy")] == 1


def test_cuda_engine_refuses_shards_across_devices(cuda):
    """A head with a shard off the engine's card is refused, by name (the
    engine's head_kwargs) or as an instance; shards all on the card are
    served."""
    from repro_torch.heads import ExactShardedHead
    eng, prompts = _graph_engine(cuda, "lstm")
    far = ExactShardedHead(eng.W, eng.b, devices=[cuda, "cpu"])
    with pytest.raises(ValueError, match="one device"):
        eng.generate(prompts, 2, head=far)
    eng._head_kwargs = dict(devices=[cuda, "cpu"])
    with pytest.raises(ValueError, match="cpu"):
        eng.resolve_head("exact-sharded")
    near = ExactShardedHead(eng.W, eng.b, devices=[cuda] * 2)
    assert eng.generate(prompts, 2, head=near).steps == 2


# -- the op-level cost counter on the card (launch/op_cost.py) ---------------

def _cost_calls(device, dtype):
    """One call of each wrapper at a small shape with distinct valid tile
    ids (the CPU's and the card's distinct-tile count then equals meta's
    every-slot one)."""
    from repro_torch.kernels.cache_update import (cache_kv_update,
                                                  cache_slot_update)
    from repro_torch.kernels.ssd import ssd_intra, ssd_intra_bwd
    g = torch.Generator().manual_seed(3)
    n_blk, d, B, K, r = 12, 64, 3, 4, 5
    t = dict(Wb=torch.randn((n_blk, 128, d), generator=g).to(dtype),
             bb=torch.randn((n_blk, 128), generator=g).to(dtype),
             h=torch.randn((B, d), generator=g).to(dtype),
             ids=torch.arange(B * K, dtype=torch.int32).reshape(B, K) % n_blk,
             v=torch.randn((r, d), generator=g),
             ck=torch.zeros((B, 16, 2, 32), dtype=dtype),
             cv=torch.zeros((B, 16, 2, 32), dtype=dtype),
             upd=torch.ones((B, 2, 32), dtype=dtype),
             xw=torch.randn((2, 1, 8, 4, 16), generator=g),
             Bm=torch.randn((2, 1, 8, 2, 8), generator=g),
             Cm=torch.randn((2, 1, 8, 2, 8), generator=g),
             l=-torch.rand((2, 1, 8, 4), generator=g).cumsum(2),
             dy=torch.randn((2, 1, 8, 4, 16), generator=g),
             dS=torch.randn((2, 1, 4, 8, 16), generator=g))
    o = {k: x.to(device) for k, x in t.items()}
    calls = {
        "route": lambda: cluster_route(o["h"], o["v"]),
        "screen": lambda: screened_logits(o["Wb"], o["bb"], o["h"], o["ids"]),
        "fused": lambda: fused_screened_topk(o["Wb"], o["bb"], o["h"],
                                             o["ids"], 5),
        "cache": lambda: cache_slot_update(o["ck"], o["upd"], 3),
        "cache pair": lambda: cache_kv_update(o["ck"], o["upd"], o["cv"],
                                              o["upd"], 3)}
    if dtype == torch.float32:
        calls["ssd"] = lambda: ssd_intra(o["xw"], o["Bm"], o["Cm"], o["l"])
        calls["ssd bwd"] = lambda: ssd_intra_bwd(o["xw"], o["Bm"], o["Cm"],
                                                 o["l"], o["dy"], o["dS"])
    return calls


def _records(call):
    from repro_torch.launch.op_cost import count_cost
    with torch.inference_mode():
        _, c = count_cost(call)
    return [(r.name, r.shapes, r.dtypes, r.flops, r.bytes) for r in c.ops]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wrapper_cost_records_equal_cpu_and_meta(cuda, dtype):
    """Each wrapper's one record on the card (it launched its kernel)
    equals its record on the CPU (the plain version) and on meta."""
    on = {dev: _cost_calls(dev, dtype) for dev in ("cuda", "cpu", "meta")}
    for name in on["cuda"]:
        before = sum(ops.LAUNCHES.values())
        got = _records(on["cuda"][name])
        assert sum(ops.LAUNCHES.values()) == before + 1, name
        assert len(got) == 1, (name, got)
        assert got == _records(on["cpu"][name]) == \
            _records(on["meta"][name]), name


def test_cuda_memory_contract_holds_on_the_card(cuda):
    """At B = 32, K = 16, d = 512 on the card: the unfused path records the
    (B, K, 128) f32 tile, the fused path none and fewer bytes, each count
    equal to the CPU's on the same inputs."""
    from repro_torch.launch.op_cost import count_cost, materializes_f32_buffer
    B, K, d, k = 32, 16, 512, 5
    g = torch.Generator().manual_seed(0)
    Wb, bb = ops.pack_head_blocks(torch.randn((4000, d), generator=g),
                                  torch.randn((4000,), generator=g))
    v = torch.randn((8, d), generator=g)
    cand = torch.randint(0, Wb.shape[0] + 2, (8, K), generator=g,
                         dtype=torch.int32)
    h = torch.randn((B, d), generator=g)
    counts = {}
    for dev in ("cuda", "cpu"):
        args = [a.to(dev) for a in (Wb, bb, v, cand, h)]
        with torch.inference_mode():
            counts[dev] = [count_cost(fn, *args, k=k)[1] for fn in
                           (ops.screened_topk, ops.screened_fused_topk)]
    unfused, fused = counts["cuda"]
    assert materializes_f32_buffer(unfused, B, K, 128)
    assert not materializes_f32_buffer(fused, B, K, 128)
    assert fused.bytes_accessed < unfused.bytes_accessed
    for a, b in zip(counts["cuda"], counts["cpu"]):
        assert (a.flops, a.bytes_accessed) == (b.flops, b.bytes_accessed)


def test_cuda_count_cost_sees_the_backward_kernel(cuda):
    """Autograd's backward on the card dispatches through the counter too:
    a loss through ``ssd_intra`` records its forward and its backward
    kernel, each as on the CPU."""
    from repro_torch.kernels.ssd import ssd_intra
    from repro_torch.launch.op_cost import count_cost
    g = torch.Generator().manual_seed(5)
    base = [torch.randn(s, generator=g) for s in
            ((2, 1, 8, 4, 16), (2, 1, 8, 2, 8), (2, 1, 8, 2, 8))]
    base.append(-torch.rand((2, 1, 8, 4), generator=g).cumsum(2))

    def loss_grad(xs):
        xs = [x.requires_grad_(True) for x in xs]
        y, S = ssd_intra(*xs)
        return torch.autograd.grad(y.sum() + S.sum(), xs)

    got = {}
    for dev in ("cuda", "cpu"):
        _, c = count_cost(loss_grad, [x.to(dev) for x in base])
        got[dev] = {n: v for n, v in c.by_name().items()
                    if n.startswith("ssd_intra")}
    assert got["cuda"] == got["cpu"]
    assert got["cuda"]["ssd_intra_bwd"]["count"] == 1


@pytest.mark.parametrize("name", ["nmt-deen-lstm", "gemma-2b"])
def test_cuda_l2s_step_on_a_one_device_mesh_is_bit_identical(cuda, name):
    """The l2s decode step at full width and depth with its params, screen,
    cache and inputs DTensors on a (1, 1) mesh over the card: the route and
    fused kernels launch through ``local_map``, as often as without a mesh,
    and the ids equal the step's without one bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import CountingMesh
    from repro_torch.launch.sharding import (NamedSharding, cache_shardings,
                                             distribute, params_shardings)
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import Model
    from repro_torch.tree import tree_map
    from repro_torch.utils import shard

    cfg = get_config(name)
    model = Model(cfg)
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = model.init(gen, device=cuda)
    dt = getattr(torch, cfg.dtype)
    n_blk = -(-cfg.vocab_size // V_BLK)
    B, S, r, K = 4, 64, 100, 16
    v = torch.randn((r, cfg.d_model), generator=gen, device=cuda)
    cand = torch.randint(0, n_blk + 1, (r, K), generator=gen, device=cuda,
                         dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=cuda,
                        dtype=torch.int32)
    pos = torch.tensor(S // 2, dtype=torch.int32, device=cuda)
    cache = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                           device=cuda).to(t.dtype),
                     model.init_cache(B, S, dtype=dt, device=cuda))
    clone = lambda c: tree_map(lambda t: t.clone(), c)      # noqa: E731
    step = make_serve_step(model, head="l2s")
    with torch.no_grad():
        ops.reset_launches()
        ids0, vals0, _ = step(params, v, cand, clone(cache), tok, pos)
        plain = dict(ops.LAUNCHES)
        with CountingMesh((1, 1), ("data", "model"),
                          device_type="cuda") as mesh:
            rep = NamedSharding(mesh, ())
            args = (distribute(params, params_shardings(mesh, cfg, params)),
                    *distribute([v, cand], [rep, rep]),
                    distribute(clone(cache),
                               cache_shardings(mesh, cfg, cache)),
                    *distribute([tok, pos], [rep, rep]))
            ops.reset_launches()
            with shard.use_mesh(mesh), implicit_replication():
                ids1, vals1, _ = step(*args)
            ids1, vals1 = ids1.to_local(), vals1.to_local()
        assert not dist.is_initialized()
    sfx = ops.BF16 if dt == torch.bfloat16 else ""
    assert ops.LAUNCHES["cluster_route" + sfx] >= 1
    assert ops.LAUNCHES["fused_screened_topk" + sfx] >= 1
    assert ops.LAUNCHES == plain
    assert torch.equal(ids0, ids1)
    torch.testing.assert_close(vals0, vals1, rtol=1e-5, atol=1e-5)
