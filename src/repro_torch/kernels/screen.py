"""screened_logits: the gather-matmul over routed candidate blocks.

Twin of ``repro/kernels/screen.py``. For each (row i, slot j) it computes the
raw ``W_blocks[block_ids[i, j]] · h[i] + b_blocks[block_ids[i, j]]``. A
sentinel id (outside [0, n_blk)) reads tile 0 and is left unmasked, as the
Pallas kernel leaves it: ``kernels/ops.py`` applies the NEG_INF mask. On a
CUDA tensor ``screened_logits`` launches ``csrc/screen.cu``; on a CPU tensor
it runs ``screened_logits_plain``; on a meta tensor it returns an empty
result (the dry run). Under ``launch/op_cost.count_cost`` it records one
``screened_logits`` op (``kernels/cost.py``): the distinct tiles read once,
h, the ids and the (B, K, V_BLK) float32 logits it writes, and the products
of every slot (a sentinel slot computes tile 0's).

The kernel runs one block per (row, slot, part of the tile): each tile is
cut into P parts (``screen_parts``) so that a decode batch of a few rows
fills the card, and the sums run in the order of the fused kernel's
(``csrc/l2s_common.cuh::l2s_warp_dot``), so the unfused and fused paths give
bit-identical logits on the card, whatever P is.

The packed head and h may be float32 or bfloat16 (all three the same
dtype: the weights' own, as the reference's heads pack them); the logits
are float32 either way, accumulated in float32 from products that are exact
there, as the Pallas kernel's ``preferred_element_type=float32`` dot. On
the card a bfloat16 head runs the kernel's bf16 body
(``screened_logits_bf16_kernel``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import V_BLK
from repro_torch.kernels import cost
from repro_torch.utils import shard


def screened_logits_plain(W_blocks, b_blocks, h, block_ids) -> torch.Tensor:
    """Plain PyTorch version → raw logits (B, K, V_BLK) f32 (a bfloat16
    head is converted to float32 first, exactly)."""
    n_blk = W_blocks.shape[0]
    valid = (block_ids >= 0) & (block_ids < n_blk)
    safe = torch.where(valid, block_ids, 0).long()
    return (torch.einsum("bkvd,bd->bkv", W_blocks[safe].float(), h.float()) +
            b_blocks[safe].float())


def check_head_inputs(W_blocks, b_blocks, h, block_ids) -> None:
    """The checks the screened and fused wrappers share: W_blocks f32 or
    bf16, b_blocks and h of the same dtype."""
    from repro_torch.kernels import ops
    dev = h.device
    ops.check_tensor(W_blocks, "W_blocks", ops.FLOATS, 3, dev)
    ops.check_tensor(b_blocks, "b_blocks", W_blocks.dtype, 2, dev)
    ops.check_tensor(h, "h", W_blocks.dtype, 2, dev)
    ops.check_tensor(block_ids, "block_ids", torch.int32, 2, dev)
    n_blk, v_blk, d = W_blocks.shape
    if v_blk != V_BLK or tuple(b_blocks.shape) != (n_blk, v_blk):
        raise ValueError(f"packed head must be (n_blk, {V_BLK}, d) + "
                         f"(n_blk, {V_BLK}); got {tuple(W_blocks.shape)} + "
                         f"{tuple(b_blocks.shape)}")
    if h.shape[1] != d or block_ids.shape[0] != h.shape[0]:
        raise ValueError(f"h {tuple(h.shape)} / block_ids "
                         f"{tuple(block_ids.shape)} do not match d={d}")


def screened_logits(W_blocks, b_blocks, h, block_ids) -> torch.Tensor:
    """W_blocks (n_blk, V_BLK, d) f32 or bf16; b_blocks (n_blk, V_BLK) and
    h (B, d) of the same dtype; block_ids (B, K) int32 (sentinel ≥ n_blk)
    → raw logits (B, K, V_BLK) f32, sentinel tiles NOT masked. DTensors
    run per device: h, the ids and the logits batch-sharded, the head
    replicated (gathered where it is sharded)."""
    from repro_torch.kernels import ops
    if shard.any_dtensor(W_blocks, b_blocks, h, block_ids):
        hp = shard.batch_placements(
            h, shard.mesh_of(W_blocks, b_blocks, h, block_ids))
        return shard.per_device(screened_logits,
                                (W_blocks, b_blocks, h, block_ids),
                                (None, None, hp, hp), (hp,))
    check_head_inputs(W_blocks, b_blocks, h, block_ids)
    dev = h.device
    n_blk, v_blk, d = W_blocks.shape
    B, K = block_ids.shape
    with cost.suspended():
        if dev.type == "cpu":
            out = screened_logits_plain(W_blocks, b_blocks, h, block_ids)
        elif dev.type == "meta":
            out = torch.empty((B, K, v_blk), dtype=torch.float32, device=dev)
        else:
            from repro_torch.kernels.fused_topk import _sm_count
            out = _launch(W_blocks, b_blocks, h, block_ids,
                          screen_parts(B, K, d, _sm_count(dev),
                                       W_blocks.element_size()))
    if cost.counting():
        # a sentinel slot reads tile 0, unmasked
        esz = W_blocks.element_size()
        tiles = cost.distinct_tiles(block_ids, n_blk,
                                       sentinel_reads_tile0=True)
        cost.record_kernel(
            "screened_logits" + (ops.BF16 if esz == 2 else ""), [out],
            2 * B * K * v_blk * d,
            tiles * v_blk * (d + 1) * esz + esz * B * d + 4 * B * K +
            4 * B * K * v_blk)
    return out


def screen_parts(B: int, K: int, d: int, n_sm: int, itemsize: int = 4) -> int:
    """Parts P each candidate tile is cut into: the fewest of 1, 2, 4, 8
    whose grid of B·K·P blocks (16 warps each) puts ⌈row bytes / 4096⌉
    blocks on every SM (8 if none), a row being d weights of ``itemsize``
    bytes. A lane keeps 8 16-byte loads in flight, so a wider row needs more
    warps per SM to stream at the card's rate: in float32 at d = 2560,
    B = 4, K = 16 P = 8 beats 4 in chip_smoke.py's sweep, at d = 500 P = 4
    beats 8."""
    for parts in (1, 2, 4, 8):
        if B * K * parts >= n_sm * -(-d * itemsize // 4096):
            return parts
    return 8


def _launch(W_blocks, b_blocks, h, block_ids, parts: int) -> torch.Tensor:
    """One launch of the kernel with each tile cut into ``parts`` parts."""
    from repro_torch.kernels import ops
    dev = h.device
    n_blk, v_blk, d = W_blocks.shape
    B, K = block_ids.shape
    sfx = ops.BF16 if W_blocks.dtype == torch.bfloat16 else ""
    out = torch.empty((B, K, v_blk), dtype=torch.float32, device=dev)
    ops.launch("screened_logits" + sfx, "screen", "l2s_screened_logits" + sfx,
               dev,
               W_blocks.data_ptr(), b_blocks.data_ptr(), h.data_ptr(),
               block_ids.data_ptr(), out.data_ptr(), B, K, n_blk, d, parts)
    return out
