"""Paged continuous-batching decode stream: page tables instead of padding.
Twin of ``repro/serving/kvpool/stream.py`` for the dense, moe and LSTM families.

``PagedDecodeStream`` is ``DecodeStream``'s drop-in sibling (same
``join``/``step``/``evict``/``pop_finished`` surface, same fixed width and
graph discipline) with each slot's cache held as a chain of pool pages.

For the DENSE family K/V rows live in the pool's device ``PagedKVStore``;
each slot owns a page chain, and the batched step decodes through
``decode_step_paged`` over (the store, the page table, the positions): the
engine's ``"greedy-paged"`` / ``"sample-paged"`` steps, one graph per
paged slab on the card, the page table a static input buffer. The page
table rows live on the host and are copied into the slab's table before
each replay. The gathered paged view has the contiguous cache's exact
shape (``page_size`` divides ``max_len``), identical values at every
unmasked position and the identical keep-mask, so greedy tokens are
bit-identical to a plain stream's. Prefix reuse is STORAGE sharing: fully
covered prompt pages are shared by reference, and the join still prefills
solo (the first token's bit-identity), writing only its private pages
(``write_prompt`` from the first unshared page on). A shared page holds
the K/V of the prefill that wrote it: on the CPU the same values as the
joining prompt's own, on the card the same where the prompts have one
length, while a prefill of another length may round the prefix rows'
last bits otherwise (its GEMMs' kernels follow the prompt length).

For the LSTM family (the paper's architecture) decode carries no per-token
KV, so pages are LOGICAL accounting (uniform admission / telemetry /
pressure semantics) and the radix cache's node payloads are recurrent
state snapshots. A prefix hit is a true COMPUTE skip: prefill resumes from
the deepest snapshot and runs only the suffix, bit-exactly (a restarted
loop is the same cell sequence), chunked at page boundaries so every new
node gets its snapshot. The port's stream caches are updated in place by
graph replays, so a payload is a clone that nothing writes later, and a
resumed prefill starts from a copy of it, never from the payload itself.
Decode rides the engine's dense stream steps outright (the same graphs a
``DecodeStream`` of the head and width replays).

Sharing is copy-on-write: a slot's first write into a page with other
holders (a cache-pinned prompt tail, a sibling slot's shared prefix)
re-allocates it privately — its rows copied in the store for the dense
family, pure accounting for the LSTM — before the batched step runs, so a
step writes only sole-holder pages (or the trash page, for idle rows).
Slots grow page-by-page on demand between steps;
``PoolExhausted`` propagates to the scheduler as the pool-pressure signal
(nothing is consumed or advanced when it fires, so the tick can simply
retry after eviction/preemption frees pages).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.serving.engine import (DecodeStream, _splice_cache,
                                        _StreamSlot)
from repro_torch.serving.kvpool.pool import PagePool, PoolExhausted
from repro_torch.serving.request import ServeRequest
from repro_torch.serving.resilience.faults import HeadFault, guard_tokens


def _clone_state(state) -> list:
    """A copy of an LSTM state (a list of {"h", "c"} per layer)."""
    return [{k: v.clone() for k, v in layer.items()} for layer in state]


class PagedDecodeStream(DecodeStream):
    """Fixed-width continuous decode over pool pages. See module docstring;
    ``DecodeStream`` documents the shared join/step/evict contract."""

    def __init__(self, engine, head, width: int, pool: PagePool,
                 temperature: Optional[float] = None, top_p: float = 1.0,
                 seed: int = 0, head_name: str = "custom"):
        if width < 1:
            raise ValueError(f"stream width must be >= 1: {width}")
        pool.bind(engine)
        super().__init__(engine, head, width, temperature=temperature,
                         top_p=top_p, seed=seed, head_name=head_name)
        self.pool = pool
        self._pages: List[List[int]] = [[] for _ in range(self.width)]
        # dense: each slot's sequence page → pool page (0 = the trash page,
        # so idle rows gather junk their mask and discard never surface)
        self.table = None
        if pool.store is not None:
            self.table = np.zeros(
                (self.width, engine.max_len // pool.page_size), np.int32)

    @property
    def pages_held(self) -> int:
        return sum(len(c) for c in self._pages)

    def _step_entry(self):
        if self.table is None:
            return super()._step_entry()
        eng = self.engine
        if self.sampled:
            return eng._paged_sample_step(self.head, self.temperature,
                                          self.top_p)
        return eng._paged_greedy_step(self.head)

    def _first_token(self, h_last) -> int:
        hd = self.head
        if self.sampled:
            first = hd.sample(h_last, self.temperature, self.top_p,
                              generator=self._gen)
        else:
            first = hd.next(h_last)
        return int(guard_tokens(self.fault_injector, "join", self.head_name,
                                first, self.vocab).ravel()[0])

    # -- join -----------------------------------------------------------------
    @torch.inference_mode()
    def join(self, request: ServeRequest, tag: object = None) -> int:
        """Admit one request: radix-match its prompt, share/COW/allocate its
        page chain, prefill (resumed from the deepest cached snapshot for
        the LSTM, solo for the dense family), then splice (LSTM) or write
        the private prompt pages (dense). Raises ``PoolExhausted`` — with
        every page reference this join took rolled back, and the
        generator's state restored — when the pool cannot back the
        prompt."""
        eng = self.engine
        Tp = int(request.prompt.shape[0])
        if Tp + request.max_new > eng.max_len:
            raise ValueError(
                f"request needs {Tp + request.max_new} cache slots, stream "
                f"max_len is {eng.max_len}")
        slot = self._first_free()
        toks = [int(t) for t in request.prompt]
        match = self.pool.radix.match(toks)
        held: List[int] = []                      # page refs this join owns
        state = None if self._gen is None else self._gen.get_state()
        try:
            if self.table is None:
                first, solo = self._join_lstm(request, toks, match, held)
            else:
                first, solo = self._join_attn(request, toks, match, held), None
        except (PoolExhausted, HeadFault):
            # same rollback either way: the pool cannot back the prompt OR
            # the head faulted mid-join — every page ref this join took is
            # released and the stream is exactly as it was
            for pg in held:
                self.pool.release(pg)
            if state is not None:
                self._gen.set_state(state)
            raise
        self._pages[slot] = held
        if self.table is not None:
            self.table[slot, :] = 0
            self.table[slot, :len(held)] = held
        entry = _StreamSlot(tag=tag, request=request, tokens=[first],
                            remaining=request.max_new - 1)
        if entry.remaining == 0:
            self._finished.append(
                (entry.tag, entry.request, np.asarray(entry.tokens, np.int32)))
            self._on_free(slot)
            return slot
        if self._slab is None:
            paged = self.table is not None
            self._slab = eng._lend_stream_slab(
                self.width, eng._token_step_key(self.head, self.temperature,
                                                self.top_p, paged),
                store=self.pool.store)
        if solo is not None:
            _splice_cache(self._slab.cache, solo, slot, eng.model.cfg)
        self.tok[slot] = first
        self.pos[slot] = Tp
        self.slots[slot] = entry
        return slot

    def _join_lstm(self, request, toks, match, held) -> tuple:
        """Resume prefill from (a copy of) the deepest cached snapshot;
        chunk the suffix at page boundaries, snapshotting each, so the
        whole prompt inserts as radix nodes. → (first token, the solo
        cache to splice)."""
        eng, pool = self.engine, self.pool
        P, Tp = pool.page_size, len(toks)
        t = match.n_full                      # snapshot exists exactly here
        for pg, _ in match.chain:
            held.append(pool.retain(pg))
        if match.payload is not None:
            cache1 = {"lstm": _clone_state(match.payload)}
        else:
            cache1 = eng.model.init_cache(1, eng.max_len,
                                          dtype=eng.cache_dtype,
                                          device=eng.device)
        snaps, h_last, i = [], None, t
        prompt = torch.as_tensor(np.asarray(request.prompt)[None],
                                 dtype=torch.long, device=eng.device)
        while i < Tp:
            n = min(P - (i % P), Tp - i)      # realign to the page grid
            h, cache1 = eng.model.prefill(
                eng.params, {"tokens": prompt[:, i:i + n]}, cache1,
                resume=True)
            i += n
            snaps.append((i, cache1["lstm"]))
            h_last = h[:, -1]
        if h_last is None:
            # whole prompt cached: the top layer's h AT the last prompt
            # token is the snapshot's own h — no forward pass needed at all
            h_last = cache1["lstm"][-1]["h"]
        first = self._first_token(h_last.contiguous())
        # page chain: a partially-covered grid slot being EXTENDED must go
        # private now (logical COW — its node's snapshot stops at t, ours
        # will stop deeper); fresh pages back the remaining grid slots
        n_prompt = (Tp + P - 1) // P
        if t < Tp and t % P:
            # in-place swap: if cow's alloc raises, held[-1] still names the
            # shared ref so join's rollback releases it — no leak either way
            held[-1] = pool.cow(held[-1])
        while len(held) < n_prompt:
            held.append(pool.alloc())
        payloads: List[object] = [None] * n_prompt
        for end, state in snaps:
            payloads[(end - 1) // P] = _clone_state(state)
        pool.radix.insert(toks, held[:n_prompt], payloads)
        pool.radix.record(t, Tp)
        return first, cache1

    def _join_attn(self, request, toks, match, held) -> int:
        """Solo full prefill (the first token's bit-identity), fully
        covered prefix pages shared by reference, private pages written
        from the solo cache for the rest. → the first token."""
        eng, pool = self.engine, self.pool
        P, Tp = pool.page_size, len(toks)
        n_prompt = (Tp + P - 1) // P
        # share only FULLY covered grid slots; a partial slot is rewritten
        # from our own prefill on a private page (counted as a COW when it
        # displaces a matched partial node's page)
        for pg, nv in match.chain:
            if nv == P:
                held.append(pool.retain(pg))
        j0 = len(held)
        if match.chain and match.chain[-1][1] < P:
            # two steps, so a failing cow leaves the retained ref in held
            # for join's rollback
            held.append(pool.retain(match.chain[-1][0]))
            held[-1] = pool.cow(held[-1])
        solo, h_last = eng._prefill(request.prompt[None], request.max_new)
        first = self._first_token(h_last)
        while len(held) < n_prompt:
            held.append(pool.alloc())
        pool.store.write_prompt(held[:n_prompt], solo.cache["attn"],
                                first_page=j0)
        pool.radix.insert(toks, held[:n_prompt])
        pool.radix.record(j0 * P, Tp)
        return first

    # -- step -----------------------------------------------------------------
    def _ensure_pages(self, idx) -> None:
        """Every active row must own a WRITABLE page at its write position
        before the batched step: grow chains page-by-page, COW pages with
        other holders. Raises ``PoolExhausted`` with nothing consumed
        (completed allocations stay in their chains and are reused on
        retry)."""
        P = self.pool.page_size
        for i in idx:
            j = int(self.pos[i]) // P
            chain = self._pages[i]
            if j == len(chain):
                chain.append(self.pool.alloc())
            else:
                chain[j] = self.pool.ensure_writable(chain[j])
            if self.table is not None:
                self.table[i, j] = chain[j]

    @torch.inference_mode()
    def step(self) -> List[tuple]:
        """One batched decode tick; same contract as ``DecodeStream.step``.
        May raise ``PoolExhausted`` BEFORE any state advances — the
        scheduler frees pages (cache eviction / preemption) and re-ticks.
        The dense family's page table goes into the slab's static table
        first, so the replay reads this tick's chains."""
        idx = [i for i, s in enumerate(self.slots) if s is not None]
        if idx:
            self._ensure_pages(idx)
            if self.table is not None:
                self._slab.table.copy_(torch.from_numpy(self.table))
        return super().step()

    # -- evict / release -------------------------------------------------------
    def _on_free(self, slot: int) -> None:
        """Release the slot's page chain (shared prefix pages just drop one
        holder; sole-owner pages free) and park it."""
        for pg in self._pages[slot]:
            self.pool.release(pg)
        self._pages[slot] = []
        if self.table is not None:
            self.table[slot, :] = 0
        self.pos[slot] = 0
        self.tok[slot] = 0
