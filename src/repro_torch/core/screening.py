"""Inference-side screening: cluster routing + screened softmax (paper Fig. 1).

Twin of ``repro/core/screening.py``. The learned candidate mask (r, n_items)
is converted once to padded index arrays:

  cand_idx (r, C_max) int32  — word (or block) ids, padded with sentinel n_items
  cand_len (r,)       int32  — true candidate count per cluster

Prediction (paper "The Prediction Process"):
  z(h) = argmax_t v_t·h                      O(r·d)
  logits over W[cand_idx[z]] + b             O(L̄·d)
  top-k within the candidate set             (padded entries = NEG_INF)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import NEG_INF, topk_desc


@dataclass
class ScreenParams:
    """Learned screening model (paper: {v_t}, {c_t}) as tensors on one
    device; ``vocab_size`` and ``block`` are plain ints."""
    v: torch.Tensor          # (r, d) cluster weights
    cand_idx: torch.Tensor   # (r, C_max) int32 padded candidate ids (word or block)
    cand_len: torch.Tensor   # (r,) int32
    vocab_size: int
    block: int = 1           # item granularity in words

    @property
    def r(self) -> int:
        return self.v.shape[0]

    @property
    def c_max(self) -> int:
        return self.cand_idx.shape[1]

    def to(self, device) -> "ScreenParams":
        return ScreenParams(v=self.v.to(device).contiguous(),
                            cand_idx=self.cand_idx.to(device).contiguous(),
                            cand_len=self.cand_len.to(device),
                            vocab_size=self.vocab_size, block=self.block)


def candidates_to_padded(mask: np.ndarray, vocab_size: int, block: int = 1,
                         pad_to_multiple: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """(r, n_items) bool → (cand_idx (r, C_max), cand_len (r,)). Sentinel = n_items.

    np.nonzero walks the mask row-major, so subtracting each row's
    cumulative offset turns flat positions into within-row slots."""
    r, n_items = mask.shape
    mask = np.asarray(mask, bool)
    lens = mask.sum(axis=1)
    c_max = int(max(int(lens.max(initial=1)), 1))
    c_max = -(-c_max // pad_to_multiple) * pad_to_multiple
    idx = np.full((r, c_max), n_items, np.int32)
    rows, cols = np.nonzero(mask)
    slots = np.arange(rows.size) - np.repeat(np.cumsum(lens) - lens, lens)
    idx[rows, slots] = cols
    return idx, lens.astype(np.int32)


def assign_clusters(v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """z(h) = argmax_t v_t·h. h: (..., d) → (...,) int32. Paper Eq.(2).
    h and v are promoted to a common dtype first (a bf16 h against a
    float32 v is scored in float32), as the reference's einsum promotes."""
    dt = torch.promote_types(h.dtype, v.dtype)
    return torch.argmax(h.to(dt) @ v.to(dt).T, dim=-1).to(torch.int32)


def screened_logits(W: torch.Tensor, b: torch.Tensor, screen: ScreenParams,
                    h: torch.Tensor, cluster: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact logits over the routed candidate set.

    W (L, d), b (L,), h (B, d), cluster (B,) →
      (logits (B, C_max·block) with NEG_INF padding,
       word_ids (B, C_max·block) with sentinel L).
    """
    L, d = W.shape
    items = screen.cand_idx[cluster.long()]               # (B, C_max)
    blk = screen.block
    n_items = -(-L // blk)
    valid = items < n_items
    safe = torch.where(valid, items, 0).long()
    if blk == 1:
        logits = torch.einsum("bcd,bd->bc", W[safe], h) + b[safe]
        logits = torch.where(valid, logits, NEG_INF)
        word_ids = torch.where(valid, items, L)
        return logits, word_ids
    # block variant: gather (C_max, block, d) tiles
    pad = n_items * blk - L
    Wp = torch.cat([W, W.new_zeros((pad, d))]).reshape(n_items, blk, d)
    bp = torch.cat([b, b.new_full((pad,), NEG_INF)]).reshape(n_items, blk)
    logits = torch.einsum("bckd,bd->bck", Wp[safe], h) + bp[safe]
    logits = torch.where(valid[..., None], logits, NEG_INF)
    lane = torch.arange(blk, device=h.device)
    word_ids = torch.where(valid[..., None], safe[..., None] * blk + lane, L)
    B = h.shape[0]
    return logits.reshape(B, -1), word_ids.reshape(B, -1)


def screened_topk(W, b, screen: ScreenParams, h, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full prediction: route → screened logits → top-k word ids.

    Returns (topk_ids (B, k) int32 — sentinel L where fewer than k
    candidates, topk_logits (B, k))."""
    cluster = assign_clusters(screen.v, h)
    logits, word_ids = screened_logits(W, b, screen, h, cluster)
    vals, pos = topk_desc(logits, k)
    return torch.gather(word_ids, 1, pos).to(torch.int32), vals
