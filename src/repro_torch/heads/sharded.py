"""Merge primitive of the vocab-sharded heads. Twin of the part of
``repro/heads/sharded.py`` that the single-device ``adaptive`` head uses
(``merge_shard_topk``); the sharded heads themselves are ROADMAP.md Queue 1
item 10."""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import NEG_INF, topk_desc


def merge_shard_topk(vals: torch.Tensor, ids: torch.Tensor, k: int,
                     sentinel: int):
    """Top-k over a concatenation of sorted top lists (B, n).

    Each part's list is sorted descending with ties at its lowest local
    index, and part p owns lower positions than part p + 1, so a stable
    descending sort of the concatenation (``topk_desc``: ties at the lowest
    position, which ``torch.topk`` does not promise) gives the global
    lowest-index order. Pads with (NEG_INF, ``sentinel``) when fewer than k
    candidates were given. → (ids (B, k) int32, vals (B, k))."""
    short = k - vals.shape[-1]
    if short > 0:
        vals = torch.cat([vals, vals.new_full((vals.shape[0], short),
                                              NEG_INF)], dim=-1)
        ids = torch.cat([ids, ids.new_full((ids.shape[0], short),
                                           sentinel)], dim=-1)
    mvals, pos = topk_desc(vals, k)
    return torch.gather(ids, -1, pos).to(torch.int32), mvals
