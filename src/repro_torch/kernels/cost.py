"""What a kernel wrapper tells the op-level cost counter.

``launch/op_cost.count_cost`` counts the aten ops a call dispatches; a
kernel wrapper (``kernels/*.py``) and a collective of ``heads/sharded.py``
are counted through this module instead, each as one op (a ``pallas_call``
seen as one custom call). While ``count_cost`` runs, ``ACTIVE`` holds its
counter; the rest of the time it is None, and each function here returns
at once after one test of it, so a wrapper called outside a count pays
about one attribute read for it. One counter is active at a time in a
process (a nested ``count_cost`` takes over and gives back the outer one).

The counter offers ``paused`` (an int: while above 0 the aten ops it sees
are not counted, nor the storage they allocate), ``add_kernel(name,
results, flops, nbytes, fresh)`` and ``add_collective(kind, parts,
result)``.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch

# the counter of the ``count_cost`` that runs, or None
ACTIVE = None

_NULL = contextlib.nullcontext()


class _Pause:
    def __init__(self, counter):
        self.counter = counter

    def __enter__(self):
        self.counter.paused += 1

    def __exit__(self, *exc):
        self.counter.paused -= 1


def counting() -> bool:
    """True inside ``count_cost``: a wrapper then works out what to
    record, which may read its inputs' data."""
    return ACTIVE is not None


def suspended():
    """A context in which no aten op is counted, and no storage an op
    allocates is tracked (a kernel wrapper's body, a collective's
    plumbing)."""
    return _NULL if ACTIVE is None else _Pause(ACTIVE)


def record_kernel(name: str, results: Sequence[torch.Tensor], flops: float,
                  nbytes: float, fresh: bool = True) -> None:
    """Record one kernel launch (a no-op outside ``count_cost``):
    ``results`` the tensors it writes (new storage when ``fresh``; rows of
    a cache written in place otherwise)."""
    if ACTIVE is not None:
        ACTIVE.add_kernel(name, results, flops, nbytes, fresh)


def record_collective(kind: str, parts: Sequence[torch.Tensor],
                      result: torch.Tensor) -> None:
    """Record one collective (a no-op outside ``count_cost``): operand and
    result bytes as an op's, the result bytes as collective bytes."""
    if ACTIVE is not None:
        ACTIVE.add_collective(kind, parts, result)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (an expanded dim, stride 0,
    counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def distinct_tiles(block_ids: torch.Tensor, n_blk: int,
                   sentinel_reads_tile0: bool = False) -> int:
    """Tiles a launch over ``block_ids`` reads, each once: the distinct
    valid ids (and tile 0, where a sentinel reads it). On the meta device,
    whose ids hold no data, every slot is taken for a distinct tile, up to
    ``n_blk``."""
    if block_ids.device.type == "meta":
        return min(block_ids.numel(), n_blk)
    with suspended():
        valid = (block_ids >= 0) & (block_ids < n_blk)
        ids = torch.where(valid, block_ids, 0) if sentinel_reads_tile0 \
            else block_ids[valid]
        return int(torch.unique(ids).numel())


def valid_slots(block_ids: torch.Tensor, n_blk: int) -> int:
    """Slots of ``block_ids`` that name a tile (a sentinel, outside
    [0, n_blk), names none). On the meta device every slot is taken for
    valid."""
    if block_ids.device.type == "meta":
        return block_ids.numel()
    with suspended():
        return int(((block_ids >= 0) & (block_ids < n_blk)).sum())
