"""The port's kernel modules (repro_torch.kernels) against the JAX package's
Pallas kernels, run in interpret mode on the same seeded numpy inputs.

On a CPU tensor each wrapper runs its plain PyTorch version, so these tests
hold that version to the reference:

  * routes and top-k ids: exactly equal;
  * on the tie and all-equal fixtures every product is exact in float32, so
    values are exactly equal too;
  * on normal fixtures values and logZ agree within rtol = atol = 1e-5 (the
    CPU sums in another order than XLA);
  * ``cache_kv_update`` (the K and V cache write of attention decode) equal,
    bit for bit, to the Pallas ``cache_slot_update`` applied to K and to V.

tests/test_torch_cuda.py holds each CUDA kernel against its plain version
on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.cache_update import cache_slot_update as j_cache_update
from repro.kernels.fused_topk import fused_screened_topk as j_fused
from repro.kernels.route import cluster_route as j_route
from repro.kernels.screen import screened_logits as j_screen
from repro_torch.kernels import ops
from repro_torch.kernels.cache_update import cache_kv_update
from repro_torch.kernels.fused_topk import fused_parts, fused_screened_topk
from repro_torch.kernels.ref import (NEG_INF, cluster_route_ref,
                                     screened_logits_ref,
                                     subset_softmax_topk_ref, topk_desc)
from repro_torch.kernels.route import cluster_route
from repro_torch.kernels.screen import screened_logits

V_BLK = 128
TOL = dict(rtol=1e-5, atol=1e-5)


def _fixture(seed, L, d, r, K, B, weights="normal"):
    """numpy inputs in the kinds of tests/test_kernels_fused.py: normal,
    quantized (dense ties) or all-equal weights; candidate slots with
    sentinels interleaved among valid block ids."""
    rng = np.random.default_rng(seed)
    if weights == "normal":
        W = rng.standard_normal((L, d))
        b = rng.standard_normal((L,))
    elif weights == "ties":
        W = np.round(rng.standard_normal((L, d)) * 2) / 2
        b = np.zeros((L,))
    else:
        W = np.zeros((L, d))
        b = np.zeros((L,))
    n_blk = -(-L // V_BLK)
    v = rng.standard_normal((r, d))
    cand = rng.integers(0, n_blk + 2, (r, K)).astype(np.int32)
    if weights == "ties":
        h = np.round(rng.standard_normal((B, d))) * 0.5
    else:
        h = rng.standard_normal((B, d))
    f32 = np.float32
    return dict(W=W.astype(f32), b=b.astype(f32), v=v.astype(f32), cand=cand,
                h=h.astype(f32), n_blk=n_blk,
                block_ids=rng.integers(0, n_blk + 2, (B, K)).astype(np.int32))


def _packed(fx):
    """(JAX packed W, b) and (port packed W, b) of one fixture."""
    jw, jb = jops.pack_head_blocks(jnp.asarray(fx["W"]), jnp.asarray(fx["b"]))
    tw, tb = ops.pack_head_blocks(torch.from_numpy(fx["W"]),
                                  torch.from_numpy(fx["b"]))
    return (jw, jb), (tw, tb)


def _t(a):
    return torch.from_numpy(np.array(a))


def _vals_equal(got, want, weights):
    if weights == "normal":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


SHAPES = [
    (1500, 128, 6, 4, 9),      # vocab NOT a multiple of 128 (padded block)
    (1024, 64, 3, 8, 4),       # exact multiple
    (130, 32, 2, 2, 7),        # tiny vocab, 2 blocks, second nearly empty
]


@pytest.mark.parametrize("L", [1500, 1024, 130])
def test_pack_head_blocks_matches(L):
    fx = _fixture(L, L, 16, 2, 2, 2)
    (jw, jb), (tw, tb) = _packed(fx)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("weights", ["normal", "ties"])
@pytest.mark.parametrize("L,d,r,K,B", SHAPES)
def test_cluster_route_matches(L, d, r, K, B, weights):
    fx = _fixture(L + d, L, d, r, K, B, weights)
    want = np.asarray(j_route(jnp.asarray(fx["h"]), jnp.asarray(fx["v"])))
    got = cluster_route(_t(fx["h"]), _t(fx["v"]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cluster_route_ref(_t(fx["h"]), _t(fx["v"])).numpy(), want)


def test_cluster_route_first_index_wins_ties():
    """Equal scores route to the lowest cluster index, as jnp.argmax."""
    h = np.ones((3, 8), np.float32)
    v = np.zeros((5, 8), np.float32)
    v[[1, 3, 4]] = 1.0
    want = np.asarray(j_route(jnp.asarray(h), jnp.asarray(v)))
    np.testing.assert_array_equal(cluster_route(_t(h), _t(v)).numpy(), want)
    assert set(want.tolist()) == {1}


@pytest.mark.parametrize("weights", ["normal", "ties", "equal"])
@pytest.mark.parametrize("L,d,r,K,B", SHAPES)
def test_screened_logits_matches(L, d, r, K, B, weights):
    """The raw kernel output (sentinel slots read tile 0, unmasked) and the
    masked oracle both agree with the reference."""
    fx = _fixture(L + K, L, d, r, K, B, weights)
    (jw, jb), (tw, tb) = _packed(fx)
    want = np.asarray(j_screen(jw, jb, jnp.asarray(fx["h"]),
                               jnp.asarray(fx["block_ids"])))
    got = screened_logits(tw, tb, _t(fx["h"]), _t(fx["block_ids"]))
    _vals_equal(got.numpy(), want, weights)
    valid = (fx["block_ids"] < fx["n_blk"])[..., None]
    ref = screened_logits_ref(tw, tb, _t(fx["h"]), _t(fx["block_ids"]))
    _vals_equal(ref.numpy(), np.where(valid, want, NEG_INF), weights)


@pytest.mark.parametrize("k,noise", [(1, False), (5, False), (64, False),
                                     (1, True), (5, True)])
@pytest.mark.parametrize("L,d,r,K,B", SHAPES)
def test_fused_topk_matches(L, d, r, K, B, k, noise):
    fx = _fixture(L + d + k, L, d, r, K, B)
    (jw, jb), (tw, tb) = _packed(fx)
    nz = (np.random.default_rng(k).gumbel(size=(B, K, V_BLK))
          .astype(np.float32) if noise else None)
    ji, jv, jz = j_fused(jw, jb, jnp.asarray(fx["h"]),
                         jnp.asarray(fx["block_ids"]), k=k,
                         noise=None if nz is None else jnp.asarray(nz))
    ti, tv, tz = fused_screened_topk(tw, tb, _t(fx["h"]), _t(fx["block_ids"]),
                                     k=k, noise=None if nz is None else _t(nz))
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    jz = np.asarray(jz)
    has = np.isfinite(jz)
    np.testing.assert_allclose(tz.numpy()[has], jz[has], **TOL)
    assert np.all(np.isneginf(tz.numpy()[~has]))


@pytest.mark.parametrize("weights", ["ties", "equal"])
@pytest.mark.parametrize("k", [1, 5, 64])
def test_fused_and_unfused_tie_break_match_reference(weights, k):
    """Dense ties and duplicate candidate blocks: ids AND values equal the
    reference's fused and unfused paths exactly (lowest flattened position
    wins a tie, as jax.lax.top_k)."""
    L, d, r, K, B = 700, 64, 5, 6, 8
    fx = _fixture(k, L, d, r, K, B, weights)
    cand = np.random.default_rng(k).integers(0, fx["n_blk"], (r, K)).astype(np.int32)
    (jw, jb), (tw, tb) = _packed(fx)
    jargs = (jw, jb, jnp.asarray(fx["v"]), jnp.asarray(cand),
             jnp.asarray(fx["h"]))
    targs = (tw, tb, _t(fx["v"]), _t(cand), _t(fx["h"]))
    ju_i, ju_v = jops.screened_topk_tpu(*jargs, k=k)
    jf_i, jf_v, _ = jops.screened_fused_topk_tpu(*jargs, k=k)
    tu_i, tu_v = ops.screened_topk(*targs, k=k)
    tf_i, tf_v, _ = ops.screened_fused_topk(*targs, k=k)
    for got_i, got_v, want_i, want_v in ((tu_i, tu_v, ju_i, ju_v),
                                         (tf_i, tf_v, jf_i, jf_v)):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("L,d,r,K,B", SHAPES)
def test_ops_compositions_match(L, d, r, K, B):
    """The four compositions against repro.kernels.ops, routing included."""
    k = 5
    fx = _fixture(L * 3 + k, L, d, r, K, B)
    (jw, jb), (tw, tb) = _packed(fx)
    jargs = (jw, jb, jnp.asarray(fx["v"]), jnp.asarray(fx["cand"]),
             jnp.asarray(fx["h"]))
    targs = (tw, tb, _t(fx["v"]), _t(fx["cand"]), _t(fx["h"]))

    jl, jw_ids = jops.screened_candidate_logits_tpu(*jargs)
    tl, tw_ids = ops.screened_candidate_logits(*targs)
    np.testing.assert_array_equal(tw_ids.numpy(), np.asarray(jw_ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    ji, jv = jops.screened_topk_tpu(*jargs, k=k)
    ti, tv = ops.screened_topk(*targs, k=k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)

    fi, fv, fz = jops.screened_fused_topk_tpu(*jargs, k=k)
    gi, gv, gz = ops.screened_fused_topk(*targs, k=k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(fi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(fv), **TOL)
    fz = np.asarray(fz)
    np.testing.assert_allclose(gz.numpy()[np.isfinite(fz)],
                               fz[np.isfinite(fz)], **TOL)
    # port fused == port unfused bit for bit
    np.testing.assert_array_equal(gi.numpy(), ti.numpy())
    np.testing.assert_array_equal(gv.numpy(), tv.numpy())

    key = jax.random.key(L + k)
    gumbel = np.asarray(jax.random.gumbel(key, (B, K, V_BLK), jnp.float32))
    js = jops.screened_fused_sample_tpu(*jargs, key, temperature=0.7)
    ts = ops.screened_fused_sample(*targs, temperature=0.7,
                                   gumbel=_t(gumbel))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_fused_all_sentinel_row():
    """All-sentinel rows: sentinel ids, NEG_INF values (equal to the
    reference), logZ = −inf, never NaN."""
    fx = _fixture(3, 500, 32, 3, 4, 5)
    (jw, jb), (tw, tb) = _packed(fx)
    ids = np.full((5, 4), fx["n_blk"] + 1, np.int32)
    ids[1] = [0, fx["n_blk"], 2, fx["n_blk"] + 3]        # one mixed row
    ji, jv, jz = j_fused(jw, jb, jnp.asarray(fx["h"]), jnp.asarray(ids), k=5)
    ti, tv, tz = fused_screened_topk(tw, tb, _t(fx["h"]), _t(ids), k=5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    empty = np.arange(5) != 1
    assert np.all(ti.numpy()[empty] == fx["n_blk"] * V_BLK)
    assert np.all(tv.numpy()[empty] == np.float32(NEG_INF))
    assert np.all(np.isneginf(tz.numpy()[empty]))
    assert np.isfinite(tz.numpy()[1]) and not np.any(np.isnan(tz.numpy()))


def test_fused_topk_rejects_k_past_the_candidates():
    fx = _fixture(0, 300, 16, 2, 2, 3)
    _, (tw, tb) = _packed(fx)
    with pytest.raises(ValueError, match="k="):
        fused_screened_topk(tw, tb, _t(fx["h"]), _t(fx["block_ids"]),
                            k=2 * V_BLK + 1)


def test_negative_block_id_is_a_sentinel():
    """A recorded divergence (ROADMAP Queue 3): the port treats a block id
    of -1 exactly as a sentinel >= n_blk. screened_logits reads tile 0 for
    it and the composition masks it (NEG_INF, sentinel word id); the fused
    path skips it (sentinel id, no mass in logZ). The reference would read
    it as a valid block with a negative word id."""
    fx = _fixture(5, 1500, 16, 1, 4, 3)
    _, (tw, tb) = _packed(fx)
    n_blk, h = fx["n_blk"], _t(fx["h"])
    neg = np.array([[0, -1, 2, -1], [-1, -1, -1, -1], [3, 1, -1, 4]], np.int32)
    sent = np.where(neg < 0, n_blk, neg).astype(np.int32)
    raw_neg = screened_logits(tw, tb, h, _t(neg))
    np.testing.assert_array_equal(raw_neg.numpy(),
                                  screened_logits(tw, tb, h, _t(sent)).numpy())
    np.testing.assert_array_equal(raw_neg.numpy()[0, 1], raw_neg.numpy()[0, 0])
    for k in (1, 5):
        got = fused_screened_topk(tw, tb, h, _t(neg), k=k)
        want = fused_screened_topk(tw, tb, h, _t(sent), k=k)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_.numpy(), w_.numpy())
        assert np.all(got[0].numpy()[1] == n_blk * V_BLK)
        assert np.all(np.isneginf(got[2].numpy()[1]))
    # routed through the composition: every row lands on the one cluster,
    # whose slots hold -1
    v, cand = _t(fx["v"]), _t(neg[2:3])
    logits, words = ops.screened_candidate_logits(tw, tb, v, cand, h)
    dead = np.repeat(neg[2] < 0, V_BLK)
    assert np.all(logits.numpy()[:, dead] == np.float32(NEG_INF))
    assert np.all(words.numpy()[:, dead] == n_blk * V_BLK)
    assert np.all(logits.numpy()[:, ~dead] > NEG_INF)


def test_subset_softmax_topk_ref_matches():
    from repro.kernels.ref import subset_softmax_topk_ref as j_ref
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 300)).astype(np.float32)
    logits[:, 250:] = NEG_INF
    logits[1, :40] = 1.5                                 # ties
    ji, jv = j_ref(jnp.asarray(logits), 7)
    ti, tv = subset_softmax_topk_ref(_t(logits), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_topk_desc_breaks_ties_by_lowest_index():
    """The reason every top-k of the port is a stable sort: torch.topk is
    free to order tied entries otherwise."""
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, pos = topk_desc(x, 3)
    want = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want[0]))


def test_wrappers_validate_inputs():
    fx = _fixture(1, 300, 16, 2, 2, 3)
    _, (tw, tb) = _packed(fx)
    h, ids = _t(fx["h"]), _t(fx["block_ids"])
    with pytest.raises(ValueError, match="int32"):
        screened_logits(tw, tb, h, ids.long())
    with pytest.raises(ValueError, match="contiguous"):
        fused_screened_topk(tw, tb, h.T.contiguous().T, ids, k=1)
    with pytest.raises(ValueError, match="does not match"):
        cluster_route(h, _t(fx["v"])[:, :8].contiguous())
    assert not any(ops.LAUNCHES.values())



def test_fused_parts_fill_the_card():
    """Each candidate tile is cut into the fewest parts (1, 2, 4, 8) whose
    B·K·P blocks put two on every SM of a 132-SM H100 (the rule alone: the
    merge fits every k)."""
    assert fused_parts(4, 16, 132) == 8   # the decode step: 512 blocks
    assert fused_parts(8, 16, 132) == 4
    assert fused_parts(1, 1, 132) == 8    # never more than 8
    assert fused_parts(4, 200, 132) == 1  # the full-cover screen
    assert fused_parts(130, 16, 132) == 1
    assert fused_parts(1, 200, 132) == 2


@pytest.mark.parametrize("routes", ["skewed", "own", "outside"])
def test_group_rows_plain_groups_pairs_by_tile(routes):
    """The grouping's plain version: ``pairs`` holds every (row, slot) once,
    sorted by the slot's tile (sentinel slots, both kinds, last) and within
    a tile stably by cluster, slot and row; the chunks cut each tile's pairs
    into runs of up to G, one tile a chunk, and fill the table's head, zeros
    after. Ids outside [0, r) count as the nearest end."""
    from repro_torch.kernels.fused_topk import (GROUP_PAIRS as G,
                                                group_chunks, group_rows,
                                                group_rows_plain)
    r, B, K, n_blk = 7, 45, 3, 6
    g = torch.Generator().manual_seed(5)
    cluster = {"skewed": torch.where(torch.rand(B, generator=g) < 0.6, 2,
                                     torch.randint(0, r, (B,), generator=g)),
               "own": torch.arange(B) % r,
               "outside": torch.randint(-2, r + 2, (B,), generator=g)}[routes]
    cluster = cluster.to(torch.int32)
    cand = torch.randint(0, n_blk, (r, K), generator=g, dtype=torch.int32)
    cand[1, 0], cand[4, 2] = n_blk, -1
    got = group_rows(cluster, cand, n_blk)              # the plain version
    for a, b in zip(got, group_rows_plain(cluster, cand, n_blk)):
        assert torch.equal(a, b)
    pairs, chunks = got
    c = cluster.long().clamp(0, r - 1)
    assert chunks.shape == (group_chunks(B, K, n_blk), 2)
    assert pairs.shape == (chunks.shape[0] * G,)
    n = int((chunks[:, 0] > 0).sum())
    assert bool((chunks[n:] == 0).all()) and bool((chunks[:n, 0] <= G).all())
    held = torch.cat([pairs[q * G:q * G + m] for q, (m, _) in
                      enumerate(chunks[:n].tolist())]).long()
    assert sorted(held.tolist()) == list(range(B * K))
    tiles = cand.long()[c[held // K], held % K]
    tiles = torch.where((tiles < 0) | (tiles >= n_blk), n_blk, tiles)
    keys = list(zip(tiles.tolist(), c[held // K].tolist(), (held % K).tolist(),
                    (held // K).tolist()))
    assert keys == sorted(keys)            # tile (sentinel last), cluster, slot, row
    for q, (m, tile) in enumerate(chunks[:n].tolist()):      # one tile a chunk
        p = pairs[q * G:q * G + m].long()
        t = cand.long()[c[p // K], p % K]
        assert set(torch.where((t < 0) | (t >= n_blk), n_blk, t).tolist()) == {tile}


def test_fused_wrapper_takes_routes_with_their_blocks():
    """The routes come as a pair (cluster, cand_blocks) matching the block
    ids; on the CPU they leave the plain version's results as they are."""
    fx = _fixture(1, 300, 16, 4, 3, 6)
    _, (tw, tb) = _packed(fx)
    h = _t(fx["h"])
    cand = _t(fx["cand"])
    cluster = cluster_route(h, _t(fx["v"]))
    ids = cand[cluster.long()].contiguous()
    with pytest.raises(ValueError, match="come together"):
        fused_screened_topk(tw, tb, h, ids, k=2, cluster=cluster)
    with pytest.raises(ValueError, match="do not match"):
        fused_screened_topk(tw, tb, h, ids, k=2, cluster=cluster[:-1].clone(),
                            cand_blocks=cand)
    got = fused_screened_topk(tw, tb, h, ids, k=2, cluster=cluster,
                              cand_blocks=cand)
    for a, b in zip(got, fused_screened_topk(tw, tb, h, ids, k=2)):
        assert torch.equal(a, b)


def test_grouped_grid_rule():
    """The grouped grid from GROUPED_MIN_ROWS rows on, when it fits: at the
    benchmark's translation batch (B = 640, K = 9, d = 500, r = 100, 196
    tiles) yes, at the decode step (B = 4) no; nor where a weight row is no
    whole number of 16-byte chunks, where the h rows of G pairs pass the
    shared memory (zamba2-2.7b's d = 2560) or where the grouping's counters
    do."""
    from repro_torch.kernels.fused_topk import (GROUPED_MIN_ROWS, SMEM_LIMIT,
                                                grouped_smem_bytes,
                                                takes_grouped)
    assert takes_grouped(640, 9, fused_parts(640, 9, 132), 500, 100, 196)
    assert not takes_grouped(4, 9, fused_parts(4, 9, 132), 500, 100, 196)
    assert takes_grouped(GROUPED_MIN_ROWS, 9, 1, 500, 100, 196)
    assert not takes_grouped(GROUPED_MIN_ROWS - 1, 9, 1, 500, 100, 196)
    assert takes_grouped(640, 16, 1, 2048, 100, 2000, esz=2)
    assert not takes_grouped(640, 16, 1, 500, 100, 196, esz=2)  # 1,000 bytes
    assert not takes_grouped(640, 16, 1, 30, 100, 196)
    assert grouped_smem_bytes(16, 1, 2560) > SMEM_LIMIT
    assert not takes_grouped(640, 16, 1, 2560, 100, 250, esz=2)
    assert not takes_grouped(640, 9, 1, 500, 40_000, 196)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slot", [0, 255, 261, -1],
                         ids=["0", "S-1", "S+5", "neg"])
def test_cache_kv_update_matches_pallas(dtype, slot):
    """Both caches written at the same slot(s), each as the Pallas kernel
    writes one (S = 256): a scalar slot, then per-row slots."""
    B, S, KV, hd = 3, 256, 2, 8
    rng = np.random.default_rng(S + slot + 7)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    caches = [jnp.asarray(rng.standard_normal((B, S, KV, hd)), jd)
              for _ in range(2)]
    upds = [jnp.asarray(rng.standard_normal((B, KV, hd)), jd)
            for _ in range(2)]

    def port(c):                       # bf16 goes through float32 exactly
        return torch.from_numpy(np.array(c, np.float32)).to(td)

    per_row = np.asarray([slot, 3, S + 5], np.int32)
    for arg, slots in ((slot, [slot] * B), (torch.from_numpy(per_row), per_row)):
        tk, tv = port(caches[0]), port(caches[1])
        got = cache_kv_update(tk, port(upds[0]), tv, port(upds[1]), arg)
        assert got[0] is tk and got[1] is tv      # in place
        for g_, cache, upd in zip(got, caches, upds):
            want = np.stack([np.asarray(j_cache_update(cache[b], upd[b],
                                                       jnp.int32(slots[b])),
                                        np.float32) for b in range(B)])
            np.testing.assert_array_equal(g_.float().numpy(), want)
    assert ops.LAUNCHES["cache_slot_update"] == 0


def test_cache_kv_update_validates_inputs():
    ck, cv = torch.zeros((2, 5, 2, 4)), torch.zeros((2, 5, 2, 4))
    upd = torch.zeros((2, 2, 4))
    with pytest.raises(ValueError, match="upd_v .* does not match"):
        cache_kv_update(ck, upd, cv, torch.zeros((2, 2, 3)), 1)
    with pytest.raises(ValueError, match="differs from cache_k"):
        cache_kv_update(ck, upd, torch.zeros((2, 6, 2, 4)), upd, 1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cache_kv_update(ck, upd, cv.double(), upd.double(), 1)
    with pytest.raises(ValueError, match="int32"):
        cache_kv_update(ck, upd, cv, upd, torch.zeros(2, dtype=torch.int64))
