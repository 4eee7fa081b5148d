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
on a CPU tensor it runs ``cache_slot_update_plain``, an index assignment; on
a meta tensor (the dry run's decode) it writes nothing. Under
``launch/op_cost.count_cost`` each call records one ``cache_slot_update``
op (``kernels/cost.py``): the update rows read and written, the cache's other rows not at all.
``cache_kv_update`` writes a K and a V cache at the same slots: one launch
on the card (counted once, under ``cache_slot_update``), two plain calls on
the CPU.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.kernels import cost
from repro_torch.utils import shard

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
    the cache's device. Writes in place and returns ``cache``. DTensors
    run per device (``_per_device``)."""
    from repro_torch.kernels import ops
    if shard.any_dtensor(cache, update, slot):
        return _per_device(cache_slot_update, (cache,), (update,), slot)[0]
    slots, k_slot = _check(cache, update, slot)
    B, S, KV, hd = cache.shape
    with cost.suspended():
        if cache.device.type == "cpu":
            cache_slot_update_plain(cache, update, slot)
        elif cache.device.type == "cuda":
            ops.launch("cache_slot_update", "cache_update",
                       "l2s_cache_slot_update", cache.device,
                       cache.data_ptr(), update.data_ptr(), slots, k_slot,
                       B, S, KV * hd * cache.element_size())
    # the update read and its rows written (a meta cache: nothing to write)
    cost.record_kernel("cache_slot_update", [update], 0,
                          2 * cost.tensor_bytes(update), fresh=False)
    return cache


def cache_kv_update(cache_k: torch.Tensor, upd_k: torch.Tensor,
                    cache_v: torch.Tensor, upd_v: torch.Tensor,
                    slot: Union[int, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cache_slot_update`` of K and of V at the same slot(s), in place:
    both caches of one shape, dtype and device. → (cache_k, cache_v).
    DTensors run per device (``_per_device``)."""
    from repro_torch.kernels import ops
    if shard.any_dtensor(cache_k, upd_k, cache_v, upd_v, slot):
        return _per_device(cache_kv_update, (cache_k, cache_v),
                           (upd_k, upd_v), slot, interleave=True)
    slots, k_slot = _check(cache_k, upd_k, slot, ("cache_k", "upd_k"))
    _check(cache_v, upd_v, slot, ("cache_v", "upd_v"))
    if cache_v.shape != cache_k.shape or cache_v.dtype != cache_k.dtype:
        raise ValueError(f"cache_v {tuple(cache_v.shape)} {cache_v.dtype} "
                         f"differs from cache_k {tuple(cache_k.shape)} "
                         f"{cache_k.dtype}")
    B, S, KV, hd = cache_k.shape
    with cost.suspended():
        if cache_k.device.type == "cpu":
            cache_slot_update_plain(cache_k, upd_k, slot)
            cache_slot_update_plain(cache_v, upd_v, slot)
        elif cache_k.device.type == "cuda":
            ops.launch("cache_slot_update", "cache_update",
                       "l2s_cache_kv_update", cache_k.device,
                       cache_k.data_ptr(), upd_k.data_ptr(),
                       cache_v.data_ptr(), upd_v.data_ptr(), slots, k_slot,
                       B, S, KV * hd * cache_k.element_size())
    cost.record_kernel("cache_slot_update", [upd_k, upd_v], 0,
                          2 * (cost.tensor_bytes(upd_k) +
                               cost.tensor_bytes(upd_v)), fresh=False)
    return cache_k, cache_v


def _per_device(fn, caches, updates, slot, interleave: bool = False):
    """``fn`` on each device's shard of DTensor caches, in place, at the
    caches' own placements: the updates split as their caches (batch,
    kv-heads, head_dim; replicated where the cache splits its sequence),
    the slots batch-split. Over a sequence-split cache a device writes
    only the slot it holds, at its local index (else nothing: slot −1).
    → the caches."""
    from torch.distributed.tensor import Replicate, Shard
    c = caches[0]
    mesh = shard.mesh_of(*caches, *updates, slot)
    cp = tuple(c.placements) if shard.is_dtensor(c) else \
        shard.replicated(mesh)
    up = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2
               else p if p == Shard(0) else Replicate() for p in cp)
    seq = Shard(1) in cp
    if seq:
        S, S_loc = c.shape[1], c.to_local().shape[1]
        off = shard.shard_offset_of(mesh, cp, 1, S)
        if isinstance(slot, torch.Tensor):
            s = slot.long().clamp(max=S - 1)
            slot = torch.where((s >= off) & (s < off + S_loc), s - off,
                               -1).to(torch.int32)
        else:
            s = min(int(slot), S - 1)
            slot = s - off if 0 <= s - off < S_loc else -1
    sp = shard.batch_placements(c, mesh) if isinstance(slot, torch.Tensor) \
        else None
    if interleave:
        args = (caches[0], updates[0], caches[1], updates[1], slot)
        pls = (cp, up, cp, up, sp)
    else:
        args = (caches[0], updates[0], slot)
        pls = (cp, up, sp)
    out = shard.per_device(fn, args, pls, (cp,) * len(caches), mesh=mesh)
    return out if isinstance(out, tuple) else (out,)
