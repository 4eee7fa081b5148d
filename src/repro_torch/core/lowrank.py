"""Perplexity with screened softmax (paper §7.3, following Shim et al.).
Twin of ``repro/core/lowrank.py``.

For words inside the routed candidate set, exact logits; outside, the
rank-ρ approximation W̃h. Probabilities are then computed over the combined
logits, which lets a top-k screening method report a full-distribution
perplexity (the paper's Table 5).

One divergence: the reference scatters the exact logits with duplicate
indices (padded candidate slots all write word 0, and with a block screen
the padded rows of the last block all write word L − 1), so which value
lands there is up to the scatter; here padded slots and padded rows write
nothing, so every word inside the candidate set gets its exact logit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.screening import ScreenParams, assign_clusters


def build_lowrank(W, rho: int):
    """(U·S (L, ρ), Vᵀ (ρ, d)) float32 of the rank-ρ SVD of W (numpy)."""
    U, S, Vt = np.linalg.svd(np.asarray(W), full_matrices=False)
    return (U[:, :rho] * S[:rho]).astype(np.float32), Vt[:rho].astype(np.float32)


def hybrid_logits(W: torch.Tensor, b: torch.Tensor, U: torch.Tensor,
                  Vt: torch.Tensor, screen: ScreenParams,
                  h: torch.Tensor) -> torch.Tensor:
    """(B, L) logits: exact inside each row's routed candidates, low-rank
    outside."""
    L, d = W.shape
    B = h.shape[0]
    approx = (h @ Vt.T) @ U.T + b                          # (B, L) low-rank
    cluster = assign_clusters(screen.v, h).long()
    items = screen.cand_idx[cluster].long()                # (B, C_max)
    blk = screen.block
    n_items = -(-L // blk)
    valid = items < n_items
    safe = torch.where(valid, items, 0)
    if blk == 1:
        word, live = safe, valid
        exact = torch.einsum("bcd,bd->bc", W[safe], h) + b[safe]
    else:
        Lpad = n_items * blk
        Wp = torch.cat([W, W.new_zeros((Lpad - L, d))]).reshape(n_items, blk,
                                                                d)
        bp = torch.cat([b, b.new_zeros((Lpad - L,))]).reshape(n_items, blk)
        exact = (torch.einsum("bckd,bd->bck", Wp[safe], h) +
                 bp[safe]).reshape(B, -1)
        word = (safe[..., None] * blk +
                torch.arange(blk, device=h.device)).reshape(B, -1)
        live = valid[..., None].expand(-1, -1, blk).reshape(B, -1) & (word < L)
    # dead slots write into a spare column L, dropped after the scatter
    out = torch.cat([approx, approx.new_zeros((B, 1))], dim=1)
    out.scatter_(1, torch.where(live, word, L), exact.to(out.dtype))
    return out[:, :L]


def _on(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def _nll_sum(logits: torch.Tensor, t: torch.Tensor) -> float:
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, 1, t[:, None].long())[:, 0]
    return float((lse - gold).sum())


def perplexity(W, b, U, Vt, screen: ScreenParams, H, targets,
               batch: int = 2048) -> float:
    """PPL over (H (N, d), targets (N,)) with hybrid logits, on W's device
    (``W``, ``b`` tensors; ``U``, ``Vt``, ``H`` and ``targets`` tensors or
    arrays)."""
    dev = W.device
    Ud, Vtd = _on(U, dev), _on(Vt, dev)
    total = 0.0
    with torch.inference_mode():
        for i in range(0, H.shape[0], batch):
            h, t = _on(H[i:i + batch], dev), _on(targets[i:i + batch], dev)
            total += _nll_sum(hybrid_logits(W, b, Ud, Vtd, screen, h), t)
    return float(np.exp(total / H.shape[0]))


def exact_perplexity(W, b, H, targets, batch: int = 2048) -> float:
    """PPL over (H (N, d), targets (N,)) with the full softmax."""
    dev = W.device
    total = 0.0
    with torch.inference_mode():
        for i in range(0, H.shape[0], batch):
            h, t = _on(H[i:i + batch], dev), _on(targets[i:i + batch], dev)
            total += _nll_sum(h @ W.T + b, t)
    return float(np.exp(total / H.shape[0]))
