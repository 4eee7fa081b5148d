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
``cache_kv_update`` writes a K and a V cache at the same slots: one launch
on the card (counted once, under ``cache_slot_update``), two plain calls on
the CPU.
"""
from __future__ import annotations

from typing import Tuple, Union

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


def _check(cache: torch.Tensor, update: torch.Tensor,
           slot: Union[int, torch.Tensor], names=("cache", "update")):
    """Raise on what the kernel does not take. → (slot pointer or None,
    the scalar slot the kernel gets)."""
    from repro_torch.kernels import ops
    dev = cache.device
    if cache.dtype not in DTYPES:
        raise ValueError(f"{names[0]} must be float32 or bfloat16, got "
                         f"{cache.dtype}")
    ops.check_tensor(cache, names[0], cache.dtype, 4, dev)
    ops.check_tensor(update, names[1], cache.dtype, 3, dev)
    B, S, KV, hd = cache.shape
    if tuple(update.shape) != (B, KV, hd) or S < 1:
        raise ValueError(f"{names[1]} {tuple(update.shape)} does not match "
                         f"{names[0]} {tuple(cache.shape)}")
    if isinstance(slot, torch.Tensor):
        ops.check_tensor(slot, "slot", torch.int32, 1, dev)
        if slot.shape[0] != B:
            raise ValueError(f"slot has {slot.shape[0]} rows, cache {B}")
        return slot.data_ptr(), 0
    slot = int(slot)
    return None, -1 if slot < 0 else min(slot, S - 1)     # int32 for the kernel


def cache_slot_update(cache: torch.Tensor, update: torch.Tensor,
                      slot: Union[int, torch.Tensor]) -> torch.Tensor:
    """cache (B, S, KV, hd) f32 or bf16, contiguous; update (B, KV, hd) of
    the same dtype; slot a Python int (every row) or a (B,) int32 tensor on
    the cache's device. Writes in place and returns ``cache``."""
    from repro_torch.kernels import ops
    slots, k_slot = _check(cache, update, slot)
    if cache.device.type == "cpu":
        return cache_slot_update_plain(cache, update, slot)
    B, S, KV, hd = cache.shape
    ops.launch("cache_slot_update", "cache_update", "l2s_cache_slot_update",
               cache.device, cache.data_ptr(), update.data_ptr(), slots, k_slot,
               B, S, KV * hd * cache.element_size())
    return cache


def cache_kv_update(cache_k: torch.Tensor, upd_k: torch.Tensor,
                    cache_v: torch.Tensor, upd_v: torch.Tensor,
                    slot: Union[int, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cache_slot_update`` of K and of V at the same slot(s), in place:
    both caches of one shape, dtype and device. → (cache_k, cache_v)."""
    from repro_torch.kernels import ops
    slots, k_slot = _check(cache_k, upd_k, slot, ("cache_k", "upd_k"))
    _check(cache_v, upd_v, slot, ("cache_v", "upd_v"))
    if cache_v.shape != cache_k.shape or cache_v.dtype != cache_k.dtype:
        raise ValueError(f"cache_v {tuple(cache_v.shape)} {cache_v.dtype} "
                         f"differs from cache_k {tuple(cache_k.shape)} "
                         f"{cache_k.dtype}")
    if cache_k.device.type == "cpu":
        return (cache_slot_update_plain(cache_k, upd_k, slot),
                cache_slot_update_plain(cache_v, upd_v, slot))
    B, S, KV, hd = cache_k.shape
    ops.launch("cache_slot_update", "cache_update", "l2s_cache_kv_update",
               cache_k.device, cache_k.data_ptr(), upd_k.data_ptr(),
               cache_v.data_ptr(), upd_v.data_ptr(), slots, k_slot, B, S,
               KV * hd * cache_k.element_size())
    return cache_k, cache_v
