"""SpecDecodeStream — continuous-batching speculative decode. Twin of
``repro/serving/spec/stream.py``.

One round = n DRAFT trunk steps through the engine's cached decode step
composed with a cheap draft head, then ONE batched VERIFY call of the
target head over the stacked draft hidden states. The draft and verify
heads share the model trunk, so the hidden state each draft step produces
IS the exact trunk state the verify head needs — verification never runs a
second forward. The win is the memory wall: plain exact decode streams the
(V, d) softmax weights from device memory once per token; batched verify
streams them once per ROUND of up to n tokens.

Round anatomy (per slot, 0-indexed; T0 = the slot's pending token at round
start, pos0 its position):

  draft step i consumes token d_{i-1} (d_{-1} = T0) at pos0 + i, yields
  hidden h_i, and the draft head picks d_i from h_i. After n steps the
  verify head scores every h_i in one call:

  greedy   e_i = verify.next(h_i); accept a = longest prefix d_i == e_i.
           Emit d_0..d_{a-1} (+ correction e_a when a < n): every emitted
           token is the exact head's greedy choice, as in solo exact decode.
  sampled  standard rejection rule over (q_i, p_i) = nucleus/temperature-
           adjusted dist_logits of draft and verify heads — emitted tokens
           follow the TARGET law exactly (spec/acceptance.py). Requires a
           verify head with ``supports_dist``. Rejection and residual draws
           come from ``np.random.default_rng(seed + 0x5bec)`` on the host,
           the draft tokens from the stream's ``torch.Generator``.

Rollback of rejected draft positions:
  * K/V caches need NONE (the dense and moe families', the hybrid's) —
    ``attn_decode``'s keep-mask hides slots beyond the resumed position
    exactly, and decode overwrites them when it re-reaches those
    positions. A dense stream's slab has no snapshot ring at all: a
    rejected row resumes by its position alone;
  * a sliding-window config's ring K/V caches are the exception: a draft
    at position p overwrites ring slot p % S, which still held position
    p − S of the next accepted token's window, so they are snapshotted
    whole with the recurrent state (``engine._rollback_leaves``), as the
    reference's snapshots are (537 MB a round's slot for mixtral-8x7b at 8
    layers, width 4);
  * recurrent state (the LSTM's (h, c); the SSM states and conv tails) is
    SNAPSHOT per draft step. The port's caches are updated in place, so a
    snapshot is a COPY into a ring preallocated with the stream's slab
    (``engine._SpecBuffers``: slot 0 the round's start, slot j the state
    after draft step j − 1), and a row resumes by copying its slot back in
    place. Nothing is allocated per round.

A round the guard refuses is undone whole (every row back to ring slot 0,
the generator's state restored): the draft steps have by then written the
slab, where the reference computes into new arrays and commits after the
guard. A retry replays the identical round.

Graph discipline: drafts ride the engine's cached ``_greedy_step`` /
``_sample_step`` (the SAME steps plain streams use), replayed on the
stream's slab; verify rides ``_spec_verify_step`` / ``_spec_dist_step``, a
graph of the head alone over the slab's (n_max, W, d) hidden buffer,
padded to a FIXED n_max so the adaptive ``DraftLenController`` shrinking n
never captures again. A second stream of the same shape is lent the same
slab and adds no graph (``compiled_step_counts`` is the audit).

KV paging: with a ``kv_pool`` the stream takes a LOGICAL page reservation
per slot — ``ceil((Tp + max_new + n_max − 1) / page_size)`` pages, the
``n_max − 1`` slack being the rejected-token positions a round can
transiently write past the request's final token. ``PoolExhausted``
propagates from ``join``; the decode itself stays in the stream's own
cache, and spec slots never dedupe prefixes through the radix cache.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.serving.engine import _splice_cache
from repro_torch.serving.observe.trace import NULL_TRACER
from repro_torch.serving.request import ServeRequest
from repro_torch.serving.resilience.faults import HeadFault, guard_tokens
from repro_torch.serving.spec.acceptance import (accept_draft,
                                                 greedy_accept_lengths)
from repro_torch.serving.spec.policy import DraftLenController


@dataclass
class _SpecSlot:
    """One occupied slot of a SpecDecodeStream."""
    tag: object
    request: ServeRequest
    tokens: list
    remaining: int
    pages: list = field(default_factory=list)   # kv_pool reservation


def _needs_snapshot(cfg) -> bool:
    """Families whose decode state cannot be rolled back by position
    masking alone: recurrent state advances destructively (the LSTM, SSM
    and hybrid families), and ring-buffer sliding windows overwrite the
    oldest slots during the draft run. A dense stack without a window rolls
    back by position alone."""
    return cfg.family in ("lstm", "ssm", "hybrid") or \
        getattr(cfg, "sliding_window", None) is not None


def _select_snapshots(spec, cache, sel, n: int, cfg) -> int:
    """Per-row snapshot restore, in place: row i resumes from the state
    after draft step ``sel[i]`` — ring slot ``sel[i] + 1``, or the live
    cache when ``sel[i] == n − 1``. The batch axis is ``_splice_cache``'s:
    0 for the LSTM state, 1 for the stacked SSM leaves and ring K/V caches.
    → rows restored."""
    axis = 0 if cfg.family == "lstm" else 1
    rows = [i for i, j in enumerate(sel) if j != n - 1]
    for i in rows:
        spec.restore_row(cache, axis, i, int(sel[i]) + 1)
    return len(rows)


class SpecDecodeStream:
    """Drop-in ``DecodeStream`` lane (same join/step/evict/pop_finished/
    occupied surface the scheduler drives) that decodes speculatively.

    One ``step()`` is one whole draft/verify ROUND, emitting 1..n tokens
    per active slot (a plain stream emits exactly 1). The first token after
    a join comes from the VERIFY head (the prefill's last hidden state is
    free), so output starts exact from token one.
    """

    def __init__(self, engine, draft_head, verify_head, width: int = 4,
                 draft_len: int = 4, temperature: Optional[float] = None,
                 top_p: float = 1.0, seed: int = 0,
                 draft_name: str = "draft", verify_name: str = "verify",
                 controller: Optional[DraftLenController] = None,
                 kv_pool=None):
        if width < 1:
            raise ValueError(f"stream width must be >= 1: {width}")
        if draft_len < 1:
            raise ValueError(f"draft_len must be >= 1: {draft_len}")
        self.engine = engine
        self.draft_head = engine.resolve_head(draft_head)
        self.verify_head = engine.resolve_head(verify_head)
        if self.draft_head.step_key() == self.verify_head.step_key():
            raise ValueError(
                "speculative decode needs DISTINCT draft and verify heads "
                f"(both resolved to {verify_name!r})")
        self.width = int(width)
        self.n_max = int(draft_len)
        self.draft_name = draft_name
        self.verify_name = verify_name
        self.head_name = f"{verify_name}+spec[{draft_name}]"
        self.temperature = temperature
        self.top_p = float(top_p)
        self.seed = int(seed)
        # temperature <= 0 is argmax — decode through the greedy machinery
        self.sampled = temperature is not None and float(temperature) > 0
        self._gen = None
        if self.sampled:
            if (self.verify_head.n_shards or 1) > 1:
                raise ValueError(
                    "sampled speculative decode needs an unsharded verify "
                    "head (sharded verify is greedy-only: full-vocab "
                    "distribution rows are never gathered)")
            for role, hd in (("draft", self.draft_head),
                             ("verify", self.verify_head)):
                if not getattr(hd, "supports_dist", False):
                    raise ValueError(
                        f"sampled speculative decode needs dist_logits on "
                        f"the {role} head ({getattr(hd, 'name', role)!r} "
                        f"has supports_dist=False)")
            self._gen = torch.Generator(device=engine.device)
            self._gen.manual_seed(self.seed)
            # rejection/residual draws: own deterministic host chain,
            # consumed in slot order each round
            self._nprng = np.random.default_rng(self.seed + 0x5bec)
        self.controller = controller
        self.kv_pool = kv_pool
        # resilience hooks: the scheduler arms the injector; draft and
        # verify boundaries guard under their OWN head names so a breaker
        # can trip the draft alone (degrade to plain decode)
        self.fault_injector = None
        self.tracer = NULL_TRACER
        self.vocab = int(engine.W.shape[0])
        self._snapshot = _needs_snapshot(engine.model.cfg)
        self._slab = None
        self.tok = np.zeros((self.width,), np.int32)
        self.pos = np.zeros((self.width,), np.int32)
        self.slots: List[Optional[_SpecSlot]] = [None] * self.width
        self._finished: List[tuple] = []
        # telemetry (cumulative; the scheduler diffs spec_counters()).
        # ``rounds`` counts PER-SLOT verify rounds (one per active slot per
        # tick), so emitted/rounds is the per-sequence accepted-tokens-per-
        # step — a plain stream scores exactly 1.0 on the same metric.
        self.rounds = 0
        self.draft_steps = 0
        self.drafted = 0
        self.accepted = 0
        self.emitted = 0
        self.verify_queries = 0
        self.verify_flops = 0.0
        self.restored_rows = 0

    # -- capacity (DecodeStream surface) -------------------------------------
    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def free_slots(self) -> int:
        return self.width - self.n_active

    @property
    def idle(self) -> bool:
        return self.n_active == 0 and not self._finished

    @property
    def cache(self) -> Optional[dict]:
        """The slab's decode cache while a slot is occupied, else None."""
        return None if self._slab is None else self._slab.cache

    def occupied(self) -> List[tuple]:
        return [(i, s.tag) for i, s in enumerate(self.slots) if s is not None]

    def _first_free(self) -> int:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        raise RuntimeError("SpecDecodeStream is full — check free_slots")

    def spec_counters(self) -> dict:
        """Cumulative round telemetry (the scheduler diffs consecutive
        snapshots into ``ServerStats.record_spec``)."""
        return {"rounds": self.rounds, "draft_steps": self.draft_steps,
                "drafted": self.drafted, "accepted": self.accepted,
                "emitted": self.emitted,
                "verify_queries": self.verify_queries,
                "verify_flops": self.verify_flops}

    def _draft_step(self):
        eng = self.engine
        if self.sampled:
            return eng._sample_step(self.draft_head, self.temperature,
                                    self.top_p)
        return eng._greedy_step(self.draft_head)

    def _slab_key(self) -> tuple:
        """The owner key of this stream's slab: one per (draft step, verify
        head, n_max), so repeated streams of the same shape are lent the
        slab (and graphs) of the ones before."""
        eng = self.engine
        return ("spec", eng._token_step_key(
            self.draft_head, self.temperature if self.sampled else None,
            self.top_p), self.verify_head.step_key(), self.n_max)

    def _release_if_empty(self) -> None:
        """Give the slab back once no slot is occupied."""
        if self._slab is not None and self.n_active == 0:
            self.engine._return_stream_slab(self._slab)
            self._slab = None

    # -- join ----------------------------------------------------------------
    @torch.inference_mode()
    def join(self, request: ServeRequest, tag: object = None) -> int:
        """Solo prefill + cache splice, first token from the VERIFY head.
        Needs ``Tp + max_new + n_max − 1 <= max_len`` — rejected draft
        positions can transiently write up to n_max − 1 slots past the
        request's final token."""
        eng = self.engine
        Tp = int(request.prompt.shape[0])
        need = Tp + request.max_new + self.n_max - 1
        if need > eng.max_len:
            raise ValueError(
                f"spec request needs {need} cache slots (prompt {Tp} + "
                f"max_new {request.max_new} + draft overshoot "
                f"{self.n_max - 1}), stream max_len is {eng.max_len}")
        slot = self._first_free()
        pages = []
        state = None if self._gen is None else self._gen.get_state()
        # ANY failure between here and the guard — pool exhaustion OR a
        # head fault mid-prefill — releases the reservation and leaves the
        # stream untouched (the splice commits only after the guard passes)
        try:
            if self.kv_pool is not None:
                P = self.kv_pool.page_size
                for _ in range(-(-need // P)):
                    pages.append(self.kv_pool.alloc())
            solo, h_last = eng._prefill(request.prompt[None], request.max_new)
            vh = self.verify_head
            if self.sampled:
                first = vh.sample(h_last, self.temperature, self.top_p,
                                  generator=self._gen)
            else:
                first = vh.next(h_last)
            first = int(guard_tokens(self.fault_injector, "join",
                                     self.verify_name, first,
                                     self.vocab).ravel()[0])
        except Exception:
            for pg in pages:
                self.kv_pool.release(pg)
            if state is not None:
                self._gen.set_state(state)
            raise
        entry = _SpecSlot(tag=tag, request=request, tokens=[first],
                          remaining=request.max_new - 1, pages=pages)
        if entry.remaining == 0:
            self._release_pages(entry)
            self._finished.append(
                (entry.tag, entry.request, np.asarray(entry.tokens,
                                                      np.int32)))
            return slot
        if self._slab is None:
            self._slab = eng._lend_stream_slab(self.width, self._slab_key(),
                                               spec_depth=self.n_max)
        _splice_cache(self._slab.cache, solo.cache, slot, eng.model.cfg)
        self.tok[slot] = first
        self.pos[slot] = Tp
        self.slots[slot] = entry
        return slot

    def _release_pages(self, entry: _SpecSlot) -> None:
        if self.kv_pool is not None:
            for pg in entry.pages:
                self.kv_pool.release(pg)
            entry.pages = []

    def _retire(self, i: int) -> None:
        """Free slot ``i``, parked at position 0 so its idle row's draft
        writes stay far from the end of the K/V cache."""
        self.slots[i] = None
        self.tok[i] = 0
        self.pos[i] = 0

    # -- the round -----------------------------------------------------------
    def _draft(self, n: int):
        """n draft steps on the slab from the host's tokens and positions,
        each step's hidden state and token copied into the round buffers
        and (recurrent families) the state after each but the last into the
        ring. → the drafted ids (W, n) on the host."""
        eng, slab = self.engine, self._slab
        spec, cache = slab.spec, slab.cache
        slab.tok.copy_(torch.from_numpy(self.tok))
        slab.pos.copy_(torch.from_numpy(self.pos))
        step = self._draft_step()
        shape = None
        if self.sampled:
            shape = self.draft_head.noise_shape(self.width, self.temperature)
        if self._snapshot:
            spec.snapshot(cache, 0)
        for j in range(n):
            if shape is not None:
                torch.rand(shape, generator=self._gen,
                           out=slab.uniforms(shape))
            h = eng._run(step, slab)
            spec.H[j].copy_(h)
            spec.drafts[j].copy_(slab.tok)
            if self._snapshot and j < n - 1:
                spec.snapshot(cache, j + 1)
        for j in range(n, self.n_max):
            spec.H[j].copy_(spec.H[n - 1])               # pad to n_max
        return spec.drafts[:n].T.cpu().numpy()

    @torch.inference_mode()
    def step(self) -> List[tuple]:
        """One draft/verify round. Returns retired (tag, request, tokens)
        triples, like ``DecodeStream.step``. A ``HeadFault`` from a guard
        leaves the stream as it was before the round."""
        out = self._finished
        self._finished = []
        idx = [i for i, s in enumerate(self.slots) if s is not None]
        if not idx:
            return out
        eng, slab = self.engine, self._slab
        n = self.n_max if self.controller is None else \
            min(max(self.controller.n, 1), self.n_max)
        start_pos = self.pos.copy()
        state = None if self._gen is None else self._gen.get_state()
        tr = self.tracer
        draft_t0 = tr.now() if tr.enabled else 0.0
        drafts = self._draft(n)                               # (W, n)
        if tr.enabled:
            tr.span("spec.draft", "kernel", draft_t0,
                    args={"head": self.draft_name, "n": n,
                          "active": len(idx)})
        verify_t0 = tr.now() if tr.enabled else 0.0
        # guard BEFORE the apply loop: every commit (tok/pos/slots) lives
        # below, and the slab is rolled back to the round's start here, so a
        # draft- or verify-boundary fault undoes the whole round and a
        # greedy retry replays it bit-identically. Draft and verify guard
        # under their own head names — the scheduler can strip a faulting
        # draft and keep decoding plain on the verify head
        try:
            if self.sampled:
                q, p = eng._run(eng._spec_dist_step(
                    self.draft_head, self.verify_head, self.n_max,
                    self.temperature, self.top_p), slab)
                q = q.cpu().numpy()                       # (n_max, W, V)
                p = p.cpu().numpy()
            else:
                exact_ids = eng._run(eng._spec_verify_step(
                    self.verify_head, self.n_max), slab).cpu().numpy()
                acc_len = greedy_accept_lengths(
                    drafts, exact_ids[:n].T)                  # (W,)
            guard_tokens(self.fault_injector, "draft", self.draft_name,
                         drafts[idx], self.vocab)
            if self.sampled:
                if self.fault_injector is not None:
                    self.fault_injector.raise_for("verify", self.verify_name)
            else:
                guard_tokens(self.fault_injector, "verify", self.verify_name,
                             exact_ids[:n][:, idx], self.vocab)
        except HeadFault:
            if self._snapshot:
                slab.spec.restore(slab.cache, 0)
            if state is not None:
                self._gen.set_state(state)
            self._finished = out
            raise
        if tr.enabled:
            tr.span("spec.verify", "kernel", verify_t0,
                    args={"head": self.verify_name, "n_max": self.n_max,
                          "active": len(idx)})

        sel = np.full((self.width,), n - 1, np.int32)        # snapshot index
        round_accepted = round_emitted = 0
        for i in idx:
            s = self.slots[i]
            if self.sampled:
                emitted, a = accept_draft(self._nprng, drafts[i],
                                          q[:n, i], p[:n, i])
            else:
                a = int(acc_len[i])
                emitted = [int(t) for t in drafts[i, :a]]
                if a < n:
                    emitted.append(int(exact_ids[a, i]))
            round_accepted += a
            take = min(len(emitted), s.remaining)
            s.tokens.extend(emitted[:take])
            s.remaining -= take
            round_emitted += take
            if a == n:
                self.tok[i] = int(drafts[i, n - 1])
                self.pos[i] = int(start_pos[i]) + n
                sel[i] = n - 1
            else:
                self.tok[i] = int(emitted[a])
                self.pos[i] = int(start_pos[i]) + a + 1
                sel[i] = a
            if s.remaining == 0:
                self._release_pages(s)
                out.append((s.tag, s.request, np.asarray(s.tokens,
                                                         np.int32)))
                self._retire(i)
                sel[i] = n - 1
        if self._snapshot:
            self.restored_rows += _select_snapshots(
                slab.spec, slab.cache, sel, n, eng.model.cfg)
        # telemetry + adaptive draft length
        self.rounds += len(idx)
        self.draft_steps += n
        self.drafted += n * len(idx)
        self.accepted += round_accepted
        self.emitted += round_emitted
        self.verify_queries += self.n_max * self.width
        vfl = self.verify_head.flops_per_query
        if vfl == vfl:                                        # NaN-safe
            self.verify_flops += float(vfl) * self.n_max * self.width
        if self.controller is not None and idx:
            self.controller.observe(round_accepted / float(n * len(idx)))
        self._release_if_empty()
        return out

    def pop_finished(self) -> List[tuple]:
        out = self._finished
        self._finished = []
        return out

    def evict(self, slot: int) -> tuple:
        s = self.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} is not occupied")
        self._release_pages(s)
        self._retire(slot)
        self._release_if_empty()
        return (s.tag, s.request, np.asarray(s.tokens, np.int32))
