"""fused_screened_topk: subset softmax + top-k over screened candidates in
one pass.

Twin of ``repro/kernels/fused_topk.py``. Per query row it gathers the K
candidate tiles, computes their logits, masks sentinel slots to NEG_INF,
keeps a running top-k with ties at the lowest flattened (slot-major,
lane-minor) position — ``jax.lax.top_k``'s order over the unfused row — and
an online log Z over the valid slots. With ``noise`` (B, K, V_BLK) the noise
is added to the valid logits after log Z (Gumbel-max sampling).

On a CUDA tensor ``fused_screened_topk`` launches ``csrc/fused_topk.cu``
on one of two grids, one algorithm (``PERF.md``'s kernel table, rows 3j–3k):

* the per-row grid: one block per (row, slot, part of the tile) writes its
  part's sorted top list and (max, sum-exp) to scratch, and the last block
  of each row to finish merges the row in the same launch, holding each
  list's head in shared memory and reading the lists from the scratch in
  L2, so every k is served;
* the grouped grid, when the call brings the routes the block ids came from
  (``cluster``, ``cand_blocks``: ``ops.screened_fused_topk`` and
  ``screened_fused_sample`` do) and B ≥ ``GROUPED_MIN_ROWS`` = 128, the
  crossover measured on the H100: ``group_rows`` groups the (row, slot)
  pairs by tile through the rows' clusters and their candidate blocks;
  one block per (chunk of up to ``GROUP_PAIRS`` pairs of one tile,
  part) loads the tile's part once for all its pairs and writes each
  pair's list and pair to the same scratch, merged the same way. At the
  benchmark's 640 rows it reads 449 tile parts where the per-row grid reads
  5,760. The adaptive head's tiers and a shard's call bring no routes and
  keep the per-row grid.

At equal P (``fused_parts``) both give the same bits. On a CPU tensor it
runs ``fused_screened_topk_plain``; on a meta tensor it returns empty
results (the dry run). Under
``launch/op_cost.count_cost`` it records one ``fused_screened_topk`` op
(``kernels/cost.py``), whose results are (ids, vals, logZ) alone: no
(B, K·V_BLK) logit tile; its products are those of the valid slots, as the
kernel skips a sentinel slot.
Both need 1 ≤ k ≤ K·V_BLK: the unfused reference's ``top_k`` refuses a
larger k, and for one the Pallas kernel pads with −inf values whose ids
repeat real candidates.

The packed head and h may be float32 or bfloat16 (one dtype for the three,
the weights' own); the noise, the logits and the outputs are float32. On the
card a bfloat16 head runs the kernel's bf16 body (``fused_topk_bf16_kernel``),
whose logits are the bits of ``screened_logits``' bf16 body.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import V_BLK
from repro_torch.kernels.ref import NEG_INF, merge_shard_topk, topk_desc
from repro_torch.kernels.screen import check_head_inputs, screened_logits_plain
from repro_torch.kernels import cost
from repro_torch.utils import shard


def fused_screened_topk_plain(W_blocks, b_blocks, h, block_ids, k: int,
                              noise: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version: the unfused row, masked, then a stable top-k
    and a logsumexp over the valid slots."""
    n_blk, v_blk, _ = W_blocks.shape
    B = h.shape[0]
    valid = ((block_ids >= 0) & (block_ids < n_blk))[..., None]
    raw = screened_logits_plain(W_blocks, b_blocks, h, block_ids)
    logz = torch.logsumexp(torch.where(valid, raw, -torch.inf).reshape(B, -1),
                           dim=-1)
    tile = torch.where(valid, raw, NEG_INF)
    if noise is not None:
        tile = torch.where(valid, tile + noise, NEG_INF)
    lane = torch.arange(v_blk, dtype=block_ids.dtype, device=h.device)
    word = torch.where(valid, block_ids[..., None] * v_blk + lane,
                       n_blk * v_blk).reshape(B, -1)
    vals, pos = topk_desc(tile.reshape(B, -1), k)
    return torch.gather(word, 1, pos).to(torch.int32), vals, logz


def fused_screened_topk(W_blocks, b_blocks, h, block_ids, k: int,
                        noise: Optional[torch.Tensor] = None,
                        cluster: Optional[torch.Tensor] = None,
                        cand_blocks: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """W_blocks (n_blk, V_BLK, d) f32 or bf16; b_blocks (n_blk, V_BLK) and
    h (B, d) of the same dtype; block_ids (B, K) int32, sentinel ≥ n_blk;
    optional noise (B, K, V_BLK) f32. → (ids (B, k) int32, vals (B, k) f32, logZ (B,) f32):
    ids/vals bit-identical to masking + stable top-k over the unfused
    (B, K·V_BLK) row; logZ is −∞ (not NaN) for all-sentinel rows.

    ``cluster`` (B,) int32 with ``cand_blocks`` (r, K) int32: the routes
    the block ids came from (``block_ids[i]`` = ``cand_blocks[cluster[i]]``).
    With them, on the card, a batch of ``GROUPED_MIN_ROWS`` rows or more
    takes the grouped grid (``takes_grouped``): the (row, slot) pairs are
    grouped by their tile through the clusters (``group_rows``), and each
    tile is loaded once per chunk of up to ``GROUP_PAIRS`` pairs, not once
    per row. Without them, or below that width, the per-row grid runs.
    Both give the same bits at equal P (``fused_parts``).
    DTensors run per device (``_per_device``, the per-row grid)."""
    from repro_torch.kernels import ops
    if shard.any_dtensor(W_blocks, b_blocks, h, block_ids, noise, cluster,
                         cand_blocks):
        return _per_device(W_blocks, b_blocks, h, block_ids, k, noise)
    check_head_inputs(W_blocks, b_blocks, h, block_ids)
    dev = h.device
    n_blk, v_blk, d = W_blocks.shape
    B, K = block_ids.shape
    if not 1 <= k <= K * v_blk:
        raise ValueError(f"k={k} must lie in [1, K·{v_blk} = {K * v_blk}]")
    if noise is not None:
        ops.check_tensor(noise, "noise", torch.float32, 3, dev)
        if tuple(noise.shape) != (B, K, v_blk):
            raise ValueError(f"noise must be {(B, K, v_blk)}, got "
                             f"{tuple(noise.shape)}")
    if (cluster is None) != (cand_blocks is None):
        raise ValueError("cluster and cand_blocks come together")
    if cluster is not None:
        ops.check_tensor(cluster, "cluster", torch.int32, 1, dev)
        ops.check_tensor(cand_blocks, "cand_blocks", torch.int32, 2, dev)
        if cluster.shape[0] != B or cand_blocks.shape[1] != K:
            raise ValueError(f"cluster {tuple(cluster.shape)} and cand_blocks "
                             f"{tuple(cand_blocks.shape)} do not match "
                             f"block_ids {(B, K)}")
    with cost.suspended():
        if dev.type == "cpu":
            out = fused_screened_topk_plain(W_blocks, b_blocks, h, block_ids,
                                            k, noise)
        elif dev.type == "meta":
            out = (torch.empty((B, k), dtype=torch.int32, device=dev),
                   torch.empty((B, k), dtype=torch.float32, device=dev),
                   torch.empty((B,), dtype=torch.float32, device=dev))
        else:
            parts = fused_parts(B, K, _sm_count(dev))
            if cluster is not None and takes_grouped(
                    B, K, parts, d, cand_blocks.shape[0], n_blk,
                    W_blocks.element_size()):
                out = _launch_grouped(W_blocks, b_blocks, h, block_ids, k,
                                      noise, parts, cluster, cand_blocks)
            else:
                out = _launch(W_blocks, b_blocks, h, block_ids, k, noise,
                              parts)
    if cost.counting():
        # the valid distinct tiles read once and the valid slots' products
        # (a sentinel slot reads and computes nothing), h, the ids and the
        # noise; only (ids, vals, logZ) written
        esz = W_blocks.element_size()
        tiles = cost.distinct_tiles(block_ids, n_blk)
        cost.record_kernel(
            "fused_screened_topk" + (ops.BF16 if esz == 2 else ""), out,
            2 * cost.valid_slots(block_ids, n_blk) * v_blk * d,
            tiles * v_blk * (d + 1) * esz + esz * B * d + 4 * B * K +
            (0 if noise is None else 4 * B * K * v_blk) +
            4 * (2 * B * k + B))
    return out


# the H100's shared memory for one block (opt-in): the launch refuses more
# (``FT_SMEM_OPTIN`` in ``csrc/fused_topk.cu``, raised by ``ops.launch``)
SMEM_LIMIT = 227 * 1024
# (row, slot) pairs of one tile a block of the grouped grid serves
# (``FT_GROUP``)
GROUP_PAIRS = 16
# the batch from which a call with known clusters takes the grouped grid:
# the crossover of the two grids' times on the H100 (``chip_smoke.py
# --only fused-batch``, ``PERF.md``'s kernel table)
GROUPED_MIN_ROWS = 128


def merge_smem_bytes(K: int, parts: int, d: int) -> int:
    """Shared memory one launch asks for (``csrc/fused_topk.cu``): phase A
    holds h and a part's logits; phase B a head, its value and position, a
    max and a sum for each of the row's K·P lists (whatever k is: the lists
    stay in L2)."""
    rows = V_BLK // parts
    return 4 * max(((d + 3) & ~3) + rows, 5 * K * parts)


def grouped_smem_bytes(K: int, parts: int, d: int) -> int:
    """Shared memory a launch of the grouped grid asks for: phase A holds
    the h rows of ``GROUP_PAIRS`` pairs, their logits and the warps' rings of
    weight chunks (``FT_RING_WORDS``: 8 warps x 4 steps x 4 rows x 32 lanes
    x 16 bytes); phase B 5 words a list for as many rows at once (up to 4)
    as fit in phase A's memory, one at least
    (``fused_topk_grouped_launch``)."""
    words_a = (GROUP_PAIRS * (((d + 3) & ~3) + V_BLK // parts)
               + 8 * 4 * 4 * 32 * 4)
    words_row = 5 * K * parts
    rows = min(max(words_a // words_row, 1), 4)
    return 4 * max(words_a, rows * words_row)


def group_chunks(B: int, K: int, n_blk: int) -> int:
    """Chunks the grouped grid has room for: ceil(B·K / G) + min(n_blk + 1,
    B·K), the most that the B·K (row, slot) pairs over n_blk tiles and the
    sentinel, cut into runs of up to G = ``GROUP_PAIRS`` pairs a tile, need."""
    return -(-B * K // GROUP_PAIRS) + min(n_blk + 1, B * K)


def takes_grouped(B: int, K: int, parts: int, d: int, r: int, n_blk: int,
                  esz: int = 4) -> bool:
    """Whether a call whose rows' clusters are known takes the grouped grid:
    B reaches the crossover ``GROUPED_MIN_ROWS`` and the launch fits (rows
    of ``esz``-byte weights in 16-byte chunks; its shared memory, d up to
    2,048; the grouping's (1 + K)·r + 2·(n_blk + 1) + 2·B counters; the
    grid's height)."""
    return (B >= GROUPED_MIN_ROWS and (d * esz) % 16 == 0
            and grouped_smem_bytes(K, parts, d) <= SMEM_LIMIT
            and 4 * ((1 + K) * r + 2 * (n_blk + 1) + 2 * B) <= SMEM_LIMIT
            and group_chunks(B, K, n_blk) <= 65_535)


def fused_parts(B: int, K: int, n_sm: int) -> int:
    """Parts P each candidate tile is cut into: the fewest of 1, 2, 4, 8
    whose grid of B·K·P blocks puts two blocks on every SM (8 if none).
    Every k fits the merge at any P (its lists stay in L2)."""
    for p in (1, 2, 4, 8):
        if B * K * p >= 2 * n_sm:
            return p
    return 8


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# (device, stream) → per-row merge counters, zero between launches
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}
# counters outgrown by a wider batch: a CUDA graph captured before may still
# hold their address, so they are kept for the life of the process
_RETIRED: List[torch.Tensor] = []


def _counters(dev: torch.device, B: int) -> torch.Tensor:
    """The kernel's per-row counters for the current stream of ``dev``:
    allocated zero, left zero by every launch, never shared by two
    streams.

    A CUDA graph bakes in the address it was captured with, so a buffer is
    never freed, and never allocated during a capture (it would live in
    that graph's private pool): a launch on the capture stream outside the
    capture, at the capture's batch width, must come first, and a capture
    that needs a new buffer raises."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < B:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "fused_screened_topk: no counters for this stream at batch "
                f"width {B}; launch once on the capture stream, outside the "
                "CUDA graph capture, first")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(B, 64), dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf


def _launch(W_blocks, b_blocks, h, block_ids, k: int, noise, parts: int):
    """One launch of the kernel with each tile cut into ``parts`` parts."""
    from repro_torch.kernels import ops
    dev = h.device
    n_blk, v_blk, d = W_blocks.shape
    B, K = block_ids.shape
    kk = min(k, v_blk // parts)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    logz = torch.empty((B,), dtype=torch.float32, device=dev)
    scratch = torch.empty((B * K * parts * (2 * kk + 2),), dtype=torch.float32,
                          device=dev)
    sfx = ops.BF16 if W_blocks.dtype == torch.bfloat16 else ""
    ops.launch("fused_screened_topk" + sfx, "fused_topk",
               "l2s_fused_screened_topk" + sfx, dev, W_blocks.data_ptr(), b_blocks.data_ptr(), h.data_ptr(),
               block_ids.data_ptr(),
               None if noise is None else noise.data_ptr(),
               ids.data_ptr(), vals.data_ptr(), logz.data_ptr(),
               scratch.data_ptr(), _counters(dev, B).data_ptr(),
               B, K, n_blk, d, k, parts)
    return ids, vals, logz


def group_rows_plain(cluster: torch.Tensor, cand_blocks: torch.Tensor,
                     n_blk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the grouping (``group_rows_kernel``):
    cluster (B,) int32 and cand_blocks (r, K) int32 (sentinel outside
    [0, n_blk)) → (pairs (``group_chunks(B, K, n_blk)``·G,) int32 and
    chunks (``group_chunks(B, K, n_blk)``, 2) int32: the (row, slot) pairs,
    row·K + slot, by the slot's tile (the sentinel n_blk last), each tile's
    cut into runs of up to G = ``GROUP_PAIRS``; chunk c = (pairs, tile),
    its pairs at pairs[c·G:c·G + pairs]; zero chunks past the last, −1 in
    the unused places). Within a tile the pairs go by cluster, slot and row.
    The kernel writes the same chunks, and each tile's pairs in another
    order (their places are taken by atomics; nothing downstream depends on
    it). A cluster id outside [0, r) counts as the nearest of 0 and r − 1."""
    dev = cluster.device
    B = cluster.shape[0]
    r, K = cand_blocks.shape
    c = cluster.long().clamp(0, r - 1)
    cand = cand_blocks.long()
    tile = torch.where((cand >= 0) & (cand < n_blk), cand, n_blk)[c]  # (B, K)
    row = torch.arange(B, device=dev)[:, None]
    slot = torch.arange(K, device=dev)
    key = ((tile * r + c[:, None]) * K + slot) * B + row
    by_tile = torch.argsort(key.flatten())
    pair = (row * K + slot).flatten()[by_tile]
    tile = tile.flatten()[by_tile]
    per_tile = torch.bincount(tile, minlength=n_blk + 1)
    per = -(-per_tile // GROUP_PAIRS)                  # chunks a tile
    first = torch.cumsum(per, 0) - per
    at = first[tile] * GROUP_PAIRS + (torch.arange(B * K, device=dev)
                                     - (torch.cumsum(per_tile, 0)
                                        - per_tile)[tile])
    n_chunks = group_chunks(B, K, n_blk)
    pairs = torch.full((n_chunks * GROUP_PAIRS,), -1, dtype=torch.int32,
                       device=dev)
    pairs[at] = pair.int()
    owner = torch.repeat_interleave(torch.arange(n_blk + 1, device=dev), per)
    q = torch.arange(owner.numel(), device=dev) - first[owner]
    chunks = torch.zeros((n_chunks, 2), dtype=torch.int32, device=dev)
    chunks[:owner.numel(), 0] = torch.clamp(
        per_tile[owner] - q * GROUP_PAIRS, max=GROUP_PAIRS).int()
    chunks[:owner.numel(), 1] = owner.int()
    return pairs, chunks


def group_rows(cluster: torch.Tensor, cand_blocks: torch.Tensor,
               n_blk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``group_rows_plain``'s (pairs, chunks): on a CUDA tensor one launch
    of ``group_rows_kernel`` (``csrc/fused_topk.cu``, one block; the unused
    places of pairs are left as they were), on a CPU tensor the plain
    version, on a meta tensor empty results of the same shapes. It runs
    inside ``fused_screened_topk``'s grouped call, whose cost record stands
    for both launches."""
    from repro_torch.kernels import ops
    dev = cluster.device
    ops.check_tensor(cluster, "cluster", torch.int32, 1, dev)
    ops.check_tensor(cand_blocks, "cand_blocks", torch.int32, 2, dev)
    B = cluster.shape[0]
    r, K = cand_blocks.shape
    if dev.type == "cpu":
        return group_rows_plain(cluster, cand_blocks, n_blk)
    n_chunks = group_chunks(B, K, n_blk)
    pairs = torch.empty((n_chunks * GROUP_PAIRS,), dtype=torch.int32,
                        device=dev)
    chunks = torch.empty((n_chunks, 2), dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        ops.launch("group_rows", "fused_topk", "l2s_group_rows", dev,
                   cluster.data_ptr(), cand_blocks.data_ptr(),
                   pairs.data_ptr(), chunks.data_ptr(), B, r, K, n_blk,
                   n_chunks)
    return pairs, chunks


def _launch_grouped(W_blocks, b_blocks, h, block_ids, k: int, noise,
                    parts: int, cluster, cand_blocks):
    """The grouping, then one launch of the grouped grid with each tile cut
    into ``parts`` parts; counted under ``fused_screened_topk_grouped``
    too."""
    from repro_torch.kernels import ops
    dev = h.device
    n_blk, v_blk, d = W_blocks.shape
    B, K = block_ids.shape
    pairs, chunks = group_rows(cluster, cand_blocks, n_blk)
    kk = min(k, v_blk // parts)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    logz = torch.empty((B,), dtype=torch.float32, device=dev)
    scratch = torch.empty((B * K * parts * (2 * kk + 2),), dtype=torch.float32,
                          device=dev)
    sfx = ops.BF16 if W_blocks.dtype == torch.bfloat16 else ""
    ops.launch("fused_screened_topk" + sfx, "fused_topk",
               "l2s_fused_screened_topk_grouped" + sfx, dev,
               W_blocks.data_ptr(), b_blocks.data_ptr(), h.data_ptr(),
               block_ids.data_ptr(),
               None if noise is None else noise.data_ptr(),
               pairs.data_ptr(), chunks.data_ptr(),
               ids.data_ptr(), vals.data_ptr(), logz.data_ptr(),
               scratch.data_ptr(), _counters(dev, B).data_ptr(),
               B, K, n_blk, d, k, parts, chunks.shape[0])
    ops.LAUNCHES["fused_screened_topk_grouped"] += 1
    return ids, vals, logz


def _per_device(W_blocks, b_blocks, h, block_ids, k: int, noise):
    """``fused_screened_topk`` on DTensors, per device: h, the ids, the
    noise and the results split over the batch as h is. A head whose tiles
    split over mesh dims (the vocab over "model") stays split: each device
    runs the kernel over its own tiles, the row's other blocks turned
    sentinels, and the devices' k best (word ids made global) and log Z
    are merged — the k best of their n·k by ``merge_shard_topk``, ties to
    the lower shard, as ``heads/sharded.py`` merges its shards; log Z the
    log-sum-exp of theirs. Otherwise the head is gathered whole."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = shard.mesh_of(W_blocks, b_blocks, h, block_ids, noise)
    hp = shard.batch_placements(h, mesh)
    np_ = None if noise is None else hp
    split = [i for i, p in enumerate(getattr(W_blocks, "placements", ()))
             if p == Shard(0)]
    if not split:
        return shard.per_device(
            fused_screened_topk, (W_blocks, b_blocks, h, block_ids, k, noise),
            (None, None, hp, hp, None, np_), (hp, hp, hp), mesh=mesh)
    n_blk = W_blocks.shape[0]
    wp = tuple(Shard(0) if i in split else Replicate()
               for i in range(mesh.ndim))
    out = tuple(Shard(1) if i in split else p for i, p in enumerate(hp))
    n_loc = n_blk // math.prod(mesh.size(i) for i in split)
    off = shard.shard_offset_of(mesh, wp, 0, n_blk)

    def local(Wl, bl, hl, il, nl):
        mine = (il >= off) & (il < off + n_loc)
        ids, vals, logz = fused_screened_topk(
            Wl, bl, hl, torch.where(mine, il - off, n_loc).to(torch.int32),
            k, nl)
        ids = torch.where(ids < n_loc * V_BLK, ids + off * V_BLK,
                          n_blk * V_BLK)
        return ids, vals, logz[:, None]
    ids, vals, logz = (shard.gathered(t) for t in shard.per_device(
        local, (W_blocks, b_blocks, h, block_ids, noise),
        (wp, wp, hp, hp, np_), (out, out, out), mesh=mesh))
    ids, vals = merge_shard_topk(vals, ids, k, sentinel=n_blk * V_BLK)
    return ids, vals, torch.logsumexp(logz, dim=1)
