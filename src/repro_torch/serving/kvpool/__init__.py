"""Paged KV-cache pool: refcounted pages with a copy-on-write shared-prefix
radix cache. Twin of ``repro/serving/kvpool`` for the dense and moe families, whose
K/V rows live in a device page store, and the LSTM family, whose pages are
logical and whose radix nodes carry recurrent-state snapshots.

Layout:
  * pool.py   — ``PagePool``: refcounted fixed-size page allocator,
                ``PoolExhausted``, COW primitives, telemetry.
  * store.py  — ``PagedKVStore``: the dense and moe families' (L, N_pages, P, KV,
                hd) K/V page tensors on the engine's device.
  * radix.py  — ``RadixCache``: token-prefix tree mapping page-grid
                chunks of prompts to shared pages (LSTM nodes also carry
                recurrent-state snapshots), LRU leaf reclamation.
  * stream.py — ``PagedDecodeStream``: the ``DecodeStream``-compatible
                continuous-batching stream running over pool pages.
"""
from repro_torch.serving.kvpool.pool import TRASH_PAGE, PagePool, PoolExhausted
from repro_torch.serving.kvpool.radix import PrefixMatch, RadixCache
from repro_torch.serving.kvpool.store import PagedKVStore
from repro_torch.serving.kvpool.stream import PagedDecodeStream

__all__ = [
    "PagedKVStore",
    "TRASH_PAGE",
    "PagePool",
    "PoolExhausted",
    "PrefixMatch",
    "RadixCache",
    "PagedDecodeStream",
]
