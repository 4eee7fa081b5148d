"""Plain PyTorch oracles for the kernels (the allclose ground truth)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def topk_desc(x: torch.Tensor, k: int):
    """(values, positions) of the k largest entries along the last axis,
    ties broken by LOWEST position — ``jax.lax.top_k``'s convention.

    ``torch.topk`` does not promise that order (on the CPU it returns
    ``[2, 4, 1]`` for ``topk([1, 3, 3, 2, 3], 3)`` where the reference
    returns ``[1, 2, 4]``), so every top-k of the port goes through a stable
    descending sort."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


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


def screened_logits_ref(W_blocks, b_blocks, h, block_ids) -> torch.Tensor:
    """Oracle for the screened-logits gather-matmul.

    W_blocks (n_blk, V_BLK, d); b_blocks (n_blk, V_BLK); h (B, d);
    block_ids (B, K) int with sentinel ≥ n_blk → masked to NEG_INF.
    Returns (B, K, V_BLK) float32.
    """
    n_blk = W_blocks.shape[0]
    valid = block_ids < n_blk
    safe = torch.where(valid, block_ids, 0).long()
    logits = torch.einsum("bkvd,bd->bkv", W_blocks[safe].float(), h.float())
    logits = logits + b_blocks[safe].float()
    return torch.where(valid[..., None], logits, NEG_INF)


def cluster_route_ref(h, v) -> torch.Tensor:
    """Oracle for fused cluster scoring + top-1 routing.

    h (B, d); v (r, d) → (B,) int32 = argmax_t v_t·h (first index wins)."""
    scores = h.float() @ v.float().T
    return torch.argmax(scores, dim=-1).to(torch.int32)


def subset_softmax_topk_ref(logits, k: int):
    """Oracle for top-k + renormalized log-probs over screened logits.

    logits (B, C) with −inf padding → (ids (B, k) int32, logprobs (B, k))."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    vals, ids = topk_desc(lp, k)
    return ids.to(torch.int32), vals
