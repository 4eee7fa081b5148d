"""cache_slot_update: predicated in-place write of one KV row per sequence.

Twin of ``repro/kernels/cache_update.py``. The Pallas kernel writes one
``(KV, hd)`` row into one ``(S, KV, hd)`` cache; the port's takes a batch of
caches ``(B, S, KV, hd)`` and one slot per row (or one slot for all rows),
and writes row b's update at ``min(slot_b, S − 1)``. A negative slot
writes nothing, as in the Pallas kernel, whose grid then holds no block
with the slot. No other byte of the cache is read or written, and the
cache is updated IN PLACE (the reference returns a new array). float32
and bfloat16; S needs no rounding to 128 (that was a TPU tiling rule).

On a CUDA tensor ``cache_slot_update`` launches ``csrc/cache_update.cu``;
on a CPU tensor it runs ``cache_slot_update_plain``, an index assignment.
"""
from __future__ import annotations

from typing import Union

import torch

DTYPES = (torch.float32, torch.bfloat16)


def cache_slot_update_plain(cache: torch.Tensor, update: torch.Tensor,
                            slot: Union[int, torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version (index assignment, in place) → ``cache``."""
    B, S = cache.shape[:2]
    if isinstance(slot, torch.Tensor):
        slots = slot.long()
    else:
        slots = torch.full((B,), int(slot), dtype=torch.long, device=cache.device)
    rows = torch.arange(B, device=cache.device)
    idx = slots.clamp(0, S - 1)
    # a row with a negative slot rewrites slot 0 with its own value
    keep = (slots >= 0)[:, None, None]
    cache[rows, idx] = torch.where(keep, update.to(cache.dtype), cache[rows, idx])
    return cache


def cache_slot_update(cache: torch.Tensor, update: torch.Tensor,
                      slot: Union[int, torch.Tensor]) -> torch.Tensor:
    """cache (B, S, KV, hd) f32 or bf16, contiguous; update (B, KV, hd) of
    the same dtype; slot a Python int (every row) or a (B,) int32 tensor on
    the cache's device. Writes in place and returns ``cache``."""
    from repro_torch.kernels import ops
    dev = cache.device
    if cache.dtype not in DTYPES:
        raise ValueError(f"cache must be float32 or bfloat16, got {cache.dtype}")
    ops.check_tensor(cache, "cache", cache.dtype, 4, dev)
    ops.check_tensor(update, "update", cache.dtype, 3, dev)
    B, S, KV, hd = cache.shape
    if tuple(update.shape) != (B, KV, hd) or S < 1:
        raise ValueError(f"update {tuple(update.shape)} does not match cache "
                         f"{tuple(cache.shape)}")
    per_row = isinstance(slot, torch.Tensor)
    if per_row:
        ops.check_tensor(slot, "slot", torch.int32, 1, dev)
        if slot.shape[0] != B:
            raise ValueError(f"slot has {slot.shape[0]} rows, cache {B}")
    else:
        slot = int(slot)
        k_slot = -1 if slot < 0 else min(slot, S - 1)     # int32 for the kernel
    if dev.type == "cpu":
        return cache_slot_update_plain(cache, update, slot)
    ops.launch("cache_slot_update", "cache_update", "l2s_cache_slot_update",
               dev, cache.data_ptr(), update.data_ptr(),
               slot.data_ptr() if per_row else None,
               0 if per_row else k_slot, B, S, KV * hd * cache.element_size())
    return cache
