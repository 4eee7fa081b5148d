"""Evaluation: Precision@k vs exact softmax, speedup models. Twin of
``repro/core/evaluate.py``: the metrics and the per-query screen are numpy,
the batched predictions torch on the tensors' device."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.screening import (ScreenParams, assign_clusters,
                                        screened_topk)
from repro_torch.kernels.ref import topk_desc


def precision_at_k(approx_ids: np.ndarray, exact_ids: np.ndarray) -> float:
    """P@k = |A_k ∩ S_k| / k averaged over queries (paper §4.2).

    approx_ids/exact_ids: (N, k) int arrays; approx may contain sentinel
    values (≥ vocab) for missing candidates — those never match.
    """
    N, k = exact_ids.shape
    hits = 0
    for i in range(N):
        hits += len(set(approx_ids[i].tolist()) & set(exact_ids[i].tolist()))
    return hits / (N * k)


def _batched(fn, H, device, batch: int) -> np.ndarray:
    out = []
    with torch.inference_mode():
        for i in range(0, H.shape[0], batch):
            h = torch.as_tensor(np.asarray(H[i:i + batch]), device=device)
            out.append(fn(h).cpu().numpy())
    return np.concatenate(out)


def exact_topk(W: torch.Tensor, b: torch.Tensor, H, k: int,
               batch: int = 4096) -> np.ndarray:
    """Exact softmax top-k ids for each row of H (N, d), on W's device."""
    return _batched(lambda h: topk_desc(h @ W.T + b, k)[1], H, W.device,
                    batch)


def screened_predictions(W: torch.Tensor, b: torch.Tensor,
                         screen: ScreenParams, H, k: int,
                         batch: int = 4096) -> np.ndarray:
    return _batched(lambda h: screened_topk(W, b, screen, h, k)[0], H,
                    W.device, batch)


def avg_candidate_size(screen: ScreenParams, H) -> float:
    """Empirical L̄ (words) under the data's routing distribution."""
    h = torch.as_tensor(np.asarray(H), device=screen.v.device)
    cl = assign_clusters(screen.v, h).cpu().numpy()
    sizes = screen.cand_len.cpu().numpy() * screen.block
    return float(sizes[cl].mean())


def speedup_model(vocab_size: int, d: int, r: int, lbar: float) -> float:
    """Analytic speedup O(L·d) / O((r+L̄)·d) — the paper's complexity claim."""
    return vocab_size / max(r + lbar, 1.0)


class PerQueryScreen:
    """Paper-protocol inference: ONE query at a time, ragged candidate sets
    (no batch padding) — the exact procedure the paper times on a single
    CPU thread. numpy throughout so full softmax and L2S pay identical
    per-op overheads."""

    def __init__(self, W, b, screen: ScreenParams):
        self.W = np.asarray(torch.as_tensor(W).cpu())
        self.b = np.asarray(torch.as_tensor(b).cpu())
        self.v = screen.v.cpu().numpy().T                   # (d, r)
        idx = screen.cand_idx.cpu().numpy()
        lens = screen.cand_len.cpu().numpy()
        self.cands = []
        for t in range(idx.shape[0]):
            items = idx[t, :lens[t]].astype(np.int64)
            if screen.block > 1:
                words = (items[:, None] * screen.block +
                         np.arange(screen.block)[None, :]).reshape(-1)
                words = words[words < screen.vocab_size]
            else:
                words = items
            self.cands.append(words)

    def topk(self, h: np.ndarray, k: int) -> np.ndarray:
        t = int(np.argmax(h @ self.v))                      # O(r·d)
        ids = self.cands[t]
        if len(ids) == 0:
            return np.full(k, self.W.shape[0], np.int64)
        logits = self.W[ids] @ h + self.b[ids]              # O(L̄·d)
        if len(ids) <= k:
            order = np.argsort(-logits)
            return np.pad(ids[order], (0, k - len(ids)),
                          constant_values=self.W.shape[0])
        part = np.argpartition(-logits, k)[:k]
        return ids[part[np.argsort(-logits[part])]]


def full_softmax_topk_numpy(W, b, h, k: int) -> np.ndarray:
    logits = W @ h + b
    part = np.argpartition(-logits, k)[:k]
    return part[np.argsort(-logits[part])]
