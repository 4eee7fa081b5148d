"""fused_screened_topk: subset softmax + top-k over screened candidates in
one pass.

Twin of ``repro/kernels/fused_topk.py``. Per query row it gathers the K
candidate tiles, computes their logits, masks sentinel slots to NEG_INF,
keeps a running top-k with ties at the lowest flattened (slot-major,
lane-minor) position — ``jax.lax.top_k``'s order over the unfused row — and
an online log Z over the valid slots. With ``noise`` (B, K, V_BLK) the noise
is added to the valid logits after log Z (Gumbel-max sampling).

On a CUDA tensor ``fused_screened_topk`` launches ``csrc/fused_topk.cu``:
one block per (row, slot, part of the tile) writes its part's sorted top list
and (max, sum-exp) to scratch, and the last block of each row to finish
merges the row in the same launch. On a CPU tensor it runs
``fused_screened_topk_plain``. Both need 1 ≤ k ≤ K·V_BLK: the unfused
reference's ``top_k`` refuses a larger k, and for one the Pallas kernel pads
with −inf values whose ids repeat real candidates.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import V_BLK
from repro_torch.kernels.ref import NEG_INF, topk_desc
from repro_torch.kernels.screen import check_head_inputs, screened_logits_plain


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
                        noise: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """W_blocks (n_blk, V_BLK, d) f32; b_blocks (n_blk, V_BLK) f32;
    h (B, d) f32; block_ids (B, K) int32, sentinel ≥ n_blk; optional noise
    (B, K, V_BLK) f32. → (ids (B, k) int32, vals (B, k) f32, logZ (B,) f32):
    ids/vals bit-identical to masking + stable top-k over the unfused
    (B, K·V_BLK) row; logZ is −∞ (not NaN) for all-sentinel rows."""
    from repro_torch.kernels import ops
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
    if dev.type == "cpu":
        return fused_screened_topk_plain(W_blocks, b_blocks, h, block_ids, k,
                                         noise)
    return _launch(W_blocks, b_blocks, h, block_ids, k, noise,
                   fused_parts(B, K, _sm_count(dev), k, d))


# the H100's shared memory for one block (opt-in): the launch refuses more
SMEM_LIMIT = 227 * 1024


def merge_smem_bytes(K: int, parts: int, k: int, d: int) -> int:
    """Shared memory one launch asks for (``csrc/fused_topk.cu``): phase A
    holds h and a part's logits, phase B the row's K·P sorted lists of
    kk = min(k, V_BLK / P) (value, position) pairs plus a head, a max and a
    sum per list."""
    rows = V_BLK // parts
    kk = min(k, rows)
    words_a = ((d + 3) & ~3) + rows
    words_b = K * parts * (2 * kk + 3)
    return 4 * max(words_a, words_b)


def fused_parts(B: int, K: int, n_sm: int, k: int, d: int) -> int:
    """Parts P each candidate tile is cut into: the fewest of 1, 2, 4, 8
    whose grid of B·K·P blocks puts two blocks on every SM (8 if none),
    then halved until the merge's shared memory fits ``SMEM_LIMIT`` (a
    smaller P merges fewer, longer lists: K·P·(2·kk + 3) words). Raises
    ``ValueError`` when even P = 1 does not fit."""
    parts = 8
    for p in (1, 2, 4, 8):
        if B * K * p >= 2 * n_sm:
            parts = p
            break
    while parts > 1 and merge_smem_bytes(K, parts, k, d) > SMEM_LIMIT:
        parts //= 2
    need = merge_smem_bytes(K, parts, k, d)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"fused_screened_topk: K={K} candidate tiles at k={k} need "
            f"{need} bytes of shared memory for the merge, past the "
            f"{SMEM_LIMIT}-byte (227 KB) limit of one block even with the "
            f"tiles uncut (P = 1)")
    return parts


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
    ops.launch("fused_screened_topk", "fused_topk", "l2s_fused_screened_topk",
               dev, W_blocks.data_ptr(), b_blocks.data_ptr(), h.data_ptr(),
               block_ids.data_ptr(),
               None if noise is None else noise.data_ptr(),
               ids.data_ptr(), vals.data_ptr(), logz.data_ptr(),
               scratch.data_ptr(), _counters(dev, B).data_ptr(),
               B, K, n_blk, d, k, parts)
    return ids, vals, logz
