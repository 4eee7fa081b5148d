"""Spec-decode policy layer: WHICH head drafts, and HOW MANY tokens. Twin
of ``repro/serving/spec/policy.py``; the default drafts lead with the
port's kernel head ``screened-cuda`` where the reference has
``screened-pallas``.

``SpecPolicy`` sits next to the routing layer: after a request is routed to
its verify head (the head whose output the caller actually gets), the
policy decides — from the same ``describe()`` cost models routing weighs —
whether a cheap draft head should speculate for it, and which one.

``DraftLenController`` is the per-stream adaptive draft length: an EMA of
the measured per-token acceptance rate shrinks n when acceptance drops
(drafting 4 tokens to keep 1 wastes three trunk steps per round) and grows
it back toward the configured maximum on sustained agreement. The engine's
verify step is padded to the configured n_max, so the controller changing n
never captures a new graph.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.serving.request import ServeRequest
from repro_torch.serving.router import EXACT_HEADS
from repro_torch.serving.scheduler.queue import head_flops, head_flops_modeled


class DraftLenController:
    """EMA acceptance tracker → current draft length n ∈ [1, n_max].

    ``observe(rate)`` feeds one round's per-token acceptance (accepted
    drafts / drafted tokens). Below ``low`` the controller steps n down;
    above ``high`` it steps back up. One step per round keeps it stable
    under bursty acceptance."""

    def __init__(self, n_max: int, low: float = 0.45, high: float = 0.75,
                 ema: float = 0.5):
        if n_max < 1:
            raise ValueError(f"draft length must be >= 1: {n_max}")
        self.n_max = int(n_max)
        self.n = int(n_max)
        self.low = float(low)
        self.high = float(high)
        self.ema = float(ema)
        self.acceptance: Optional[float] = None

    def observe(self, rate: float) -> int:
        rate = min(max(float(rate), 0.0), 1.0)
        self.acceptance = rate if self.acceptance is None else \
            (1.0 - self.ema) * self.acceptance + self.ema * rate
        if self.acceptance < self.low:
            self.n = max(1, self.n - 1)
        elif self.acceptance > self.high:
            self.n = min(self.n_max, self.n + 1)
        return self.n


class SpecPolicy:
    """Pick a draft head for a routed verify head from catalog cost models.

    ``drafts``       candidate draft heads, preference-ordered; the pick is
                     the cheapest by per-shard ``flops_per_query`` (bytes
                     tie-break, mirroring ``CostAwarePolicy``).
    ``draft_len``    tokens drafted per verify round (the controller's
                     n_max); ``ServeRequest.draft_len`` overrides per
                     request.
    ``min_ratio``    required verify_flops / draft_flops advantage — a
                     draft nearly as expensive as its verify head burns a
                     trunk step per token for nothing.
    ``verify_heads`` heads worth speculating FOR (default: the exact
                     family — a request already routed to a cheap
                     approximate head has nothing to amortize).
    ``adaptive``     give each spec stream a ``DraftLenController``.

    ``draft_for`` returns None (= serve plain) whenever speculation cannot
    help or cannot be exact: unknown/uncataloged draft, insufficient flops
    advantage, a sampled request whose draft or verify head lacks
    ``dist_logits`` (the rejection rule needs both laws in vocab
    coordinates), a sampled request on a SHARDED verify head (only greedy
    id-comparison is supported there — full-vocab distribution rows are
    never gathered), or a request whose cache headroom can't carry the
    draft overshoot."""

    def __init__(self, drafts: Sequence[str] = ("screened-cuda",
                                                "screened", "adaptive"),
                 draft_len: int = 4, min_ratio: float = 2.0,
                 verify_heads: Optional[Sequence[str]] = None,
                 adaptive: bool = True):
        if draft_len < 1:
            raise ValueError(f"draft_len must be >= 1: {draft_len}")
        self.drafts = tuple(dict.fromkeys(drafts))
        self.candidates = self.drafts        # catalog names, router-style
        self.draft_len = int(draft_len)
        self.min_ratio = float(min_ratio)
        self.verify_heads = frozenset(EXACT_HEADS if verify_heads is None
                                      else verify_heads)
        self.adaptive = bool(adaptive)

    # -- helpers -------------------------------------------------------------
    def draft_len_for(self, request: ServeRequest,
                      max_len: Optional[int] = None) -> int:
        n = request.draft_len if request.draft_len is not None \
            else self.draft_len
        if max_len is not None:
            # draft overshoot: a round can write n−1 rejected positions past
            # the request's final token, so the cache must hold
            # Tp + max_new + n − 1 slots
            headroom = max_len - int(request.prompt.shape[0]) \
                - int(request.max_new) + 1
            n = min(n, headroom)
        return n

    def _ok_for_request(self, name: str, meta: dict, request: ServeRequest,
                        verify_meta: dict) -> bool:
        if meta.get("breaker_open"):
            # tripped draft head: serve plain rather than speculate on a
            # head the breaker took out (same stamp head_eligible honors)
            return False
        if request.sampled:
            if not meta.get("supports_sampling", True):
                return False
            if not meta.get("supports_dist", False):
                return False
            if not verify_meta.get("supports_dist", False):
                return False
        return True

    def draft_for(self, request: ServeRequest, verify_name: str,
                  catalog: Dict[str, dict],
                  max_len: Optional[int] = None) -> Optional[str]:
        verify_meta = catalog.get(verify_name)
        if verify_meta is None:
            return None
        if request.sampled and (verify_meta.get("n_shards") or 0) > 1:
            return None                      # sharded verify: greedy only
        if self.draft_len_for(request, max_len) < 2:
            return None                      # no room (or wish) to speculate
        if request.draft_head is not None:
            # explicit escape hatch: honored when buildable and compatible
            meta = catalog.get(request.draft_head)
            if meta is None or request.draft_head == verify_name or \
                    not self._ok_for_request(request.draft_head, meta,
                                             request, verify_meta):
                return None
            return request.draft_head
        if verify_name not in self.verify_heads:
            return None
        vflops = head_flops(catalog, verify_name)
        if not head_flops_modeled(catalog, verify_name) or vflops <= 0:
            return None
        ranked = []
        for i, name in enumerate(self.drafts):
            meta = catalog.get(name)
            if meta is None or name == verify_name:
                continue
            if not head_flops_modeled(catalog, name):
                continue                     # NaN-cost drafts never win
            if not self._ok_for_request(name, meta, request, verify_meta):
                continue
            dflops = head_flops(catalog, name)
            if dflops <= 0 or vflops / dflops < self.min_ratio:
                continue
            b = meta.get("bytes_per_query")
            b = float("inf") if b is None or b != b else float(b)
            ranked.append((dflops, b, i, name))
        if not ranked:
            return None
        return min(ranked)[3]

    def controller_for(self, draft_len: int) -> Optional[DraftLenController]:
        return DraftLenController(draft_len) if self.adaptive else None


def spec_step_flops(catalog: Dict[str, dict], draft: str,
                    verify: Optional[str]) -> float:
    """Per-trunk-step flops CHARGE for a spec-served request: every draft
    step pays the draft head, and the n_max-query verify round amortizes to
    one verify query per step when the controller runs at n = n_max (its
    starting point; shrinking n only raises the true share, so this is the
    admission floor). Speculation deliberately charges MORE flops than
    plain exact decode — its win is HBM traffic (the (V, d) softmax weights
    stream once per round instead of once per token), which the flops
    budget does not model."""
    return head_flops(catalog, draft) + head_flops(catalog, verify)
