"""Block-paged KV memory: refcounted fixed-size pages + typed exhaustion.
Twin of ``repro/serving/kvpool/pool.py`` for the LSTM, dense and moe families:
``bind`` raises NotImplementedError for the other families and for a
sliding-window (ring) cache.

``PagePool`` is the bookkeeping core of the paged serving path: KV capacity
is carved into ``num_pages`` pages of ``page_size`` token slots each, and
every live occupant — a stream slot's page chain, or the radix prefix
cache pinning shared prompt pages — holds an explicit reference. Sharing is
refcounting (``retain``); divergence is copy-on-write (``ensure_writable``:
a page with more than one holder is re-allocated privately before its first
write, its K/V rows copied for the dense family; the LSTM's pages have no
rows to copy).

The pool is deliberately split from physical storage:

  * pure bookkeeping (this class, unbound) is what the hypothesis property
    suite drives through thousands of random alloc/share/COW/free
    sequences — no tensors, no graphs, just the invariants;
  * ``bind(engine)`` attaches the model-specific substance: the
    device-side ``PagedKVStore`` (store.py) for the dense and moe families; for the
    LSTM family nothing, its "pages" being logical accounting over
    recurrent-state snapshots held by the radix cache (see radix.py) —
    admission and telemetry stay uniform either way.

Page 0 is RESERVED as the trash page: idle stream slots park their page
table entries (and their per-step scatter writes) there, so the decode
step's shapes never depend on occupancy. It is never allocated and its
contents are junk by design — only masked or discarded rows ever read it.

``alloc()`` under pressure first asks the radix cache to evict unpinned
LRU leaves (the ``reclaimer`` hook); only when nothing is reclaimable does
it raise ``PoolExhausted`` — the typed signal ``ContinuousScheduler``
turns into preemption or a typed admission reject.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

TRASH_PAGE = 0


class PoolExhausted(RuntimeError):
    """The pool cannot supply the requested pages, even after reclaiming
    cache-held ones. Carries the shortfall so schedulers/admission can
    report a typed, quantified reason."""

    def __init__(self, needed: int = 1, free: int = 0, total: int = 0):
        self.needed = int(needed)
        self.free = int(free)
        self.total = int(total)
        super().__init__(
            f"KV page pool exhausted: need {needed} page(s), "
            f"{free} free of {total} allocatable")


class PagePool:
    """Refcounted allocator of fixed-size KV pages (page 0 = trash).

    ``page_size`` must divide the serving ``max_len`` it is bound to, so a
    stream's gathered paged view has exactly the dense cache's shape — the
    structural half of the bit-identity guarantee (see stream.py).
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is reserved "
                             f"as the trash page): {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1: {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list: most-recently-freed page is reused first, which
        # maximizes the stale-content reuse the masking regression tests pin
        self._free: List[int] = list(range(1, self.num_pages))
        self._free.reverse()
        self._refs: Dict[int, int] = {}
        self.cow_copies = 0              # cumulative logical COWs
        self.peak_in_use = 0
        self.reclaimer: Optional[Callable[[int], int]] = None
        self.radix = None                # RadixCache (set by bind/attach)
        self.store = None                # PagedKVStore (dense, set by bind)
        self._engine = None

    # -- core refcounted alloc/free ------------------------------------------
    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def ref(self, page: int) -> int:
        """Live refcount of ``page`` (0 = free / trash)."""
        return self._refs.get(int(page), 0)

    def writable(self, page: int) -> bool:
        """A page is writable only by its sole holder."""
        return self._refs.get(int(page), 0) == 1

    def live_pages(self) -> Dict[int, int]:
        """{page: refcount} snapshot — the property suite's ground truth."""
        return dict(self._refs)

    def alloc(self) -> int:
        """Take one page (ref 1). Reclaims cache-held pages via the
        ``reclaimer`` hook before giving up with ``PoolExhausted``."""
        if not self._free and self.reclaimer is not None:
            self.reclaimer(1)
        if not self._free:
            raise PoolExhausted(needed=1, free=0, total=self.num_pages - 1)
        page = self._free.pop()
        self._refs[page] = 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return page

    def retain(self, page: int) -> int:
        """Add a holder to a live page (prefix sharing)."""
        page = int(page)
        if page not in self._refs:
            raise ValueError(f"retain of non-live page {page}")
        self._refs[page] += 1
        return page

    def release(self, page: int) -> None:
        """Drop one holder; a page with no holders returns to the free
        list. Releasing a free/trash page is a DOUBLE FREE and raises."""
        page = int(page)
        n = self._refs.get(page)
        if n is None:
            raise ValueError(f"double free / release of non-live page {page}")
        if n == 1:
            del self._refs[page]
            self._free.append(page)
        else:
            self._refs[page] = n - 1

    def cow(self, page: int) -> int:
        """Logical copy-on-write: trade one reference on a shared ``page``
        for a fresh private page."""
        page = int(page)
        if page not in self._refs:
            raise ValueError(f"cow of non-live page {page}")
        new = self.alloc()
        self.release(page)
        self.cow_copies += 1
        return new

    def ensure_writable(self, page: int) -> int:
        """Return a page the caller may write: ``page`` itself when it is
        the sole holder, else a COW copy (its rows duplicated when a device
        store is bound; the copy is taken BEFORE the old reference is
        dropped, so no reallocation can clobber the source)."""
        page = int(page)
        if self.writable(page):
            return page
        new = self.alloc()
        if self.store is not None:
            self.store.copy_page(page, new)
        self.release(page)
        self.cow_copies += 1
        return new

    # -- binding to an engine -------------------------------------------------
    def bind(self, engine) -> None:
        """Attach this pool to a ``DecodeEngine`` (idempotent; one engine
        per pool). Builds the device ``PagedKVStore`` for the dense and moe families,
        in the engine's cache dtype on its device; the LSTM family stays
        logical: its pages are accounting over the recurrent-state
        snapshots the radix cache holds. Called by ``PagedDecodeStream`` —
        users just construct ``PagePool(...)``."""
        if self._engine is engine:
            return
        if self._engine is not None:
            raise ValueError("PagePool is already bound to another engine")
        if engine.max_len % self.page_size:
            raise ValueError(
                f"page_size {self.page_size} must divide engine max_len "
                f"{engine.max_len} (the paged view must have the dense "
                f"cache's exact shape for bit-identical decode)")
        cfg = engine.model.cfg
        if cfg.family in ("dense", "moe"):
            if cfg.sliding_window is not None:
                raise NotImplementedError(
                    "paged KV does not support sliding-window (ring) "
                    f"caches: {cfg.name}")
            from repro_torch.serving.kvpool.store import PagedKVStore
            self.store = PagedKVStore(cfg, self.num_pages, self.page_size,
                                      engine.cache_dtype, engine.device)
        elif cfg.family != "lstm":
            raise NotImplementedError(
                f"paged KV supports the lstm, dense and moe families, not "
                f"{cfg.family} ({cfg.name})")
        if self.radix is None:
            from repro_torch.serving.kvpool.radix import RadixCache
            self.radix = RadixCache(self)
        self.reclaimer = self.radix.reclaim
        self._engine = engine

    # -- telemetry -------------------------------------------------------------
    def bytes_per_page(self) -> int:
        """Device bytes one resident page costs. Dense: the store's K/V
        rows of a page. LSTM: the recurrent-state snapshot a cached page
        carries (2 * L * d floats) — its pages are logical, so this is the
        accounting rate for residency, not a tensor stride (0 while
        unbound)."""
        if self.store is not None:
            return self.store.bytes_per_page
        eng = self._engine
        if eng is None:
            return 0
        cfg = eng.model.cfg
        itemsize = torch.empty((), dtype=eng.cache_dtype).element_size()
        return 2 * cfg.num_layers * cfg.d_model * itemsize

    def telemetry(self) -> dict:
        """JSON-ready pool snapshot — merged into ``ServerStats`` and the
        serving benchmark JSON."""
        out = {
            "page_size": self.page_size,
            "pages_total": self.num_pages - 1,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.pages_free,
            "peak_pages_in_use": self.peak_in_use,
            "cow_copies": self.cow_copies,
            "bytes_per_page": self.bytes_per_page(),
            "hbm_resident_bytes": self.pages_in_use * self.bytes_per_page(),
            "store_bytes": self.store.nbytes if self.store is not None else 0,
        }
        if self.radix is not None:
            out["prefix"] = self.radix.telemetry()
        return out
