"""The c-step of Algorithm 1: candidate-set selection as a Knapsack problem.
A numpy copy of ``repro/core/knapsack.py`` (the c-step runs on the host).

With cluster assignments fixed, Eq.(7) decomposes per (cluster t, item s)
where an item is a vocab word (paper) or a vocab block of V_BLK words (TPU
adaptation):

  value_ts  = n_ts − λ·(k·N_t/|item| − n_ts)·|item|⁻¹-ish … concretely:
    n_ts   = Σ_{i∈cluster t} [s ∈ y_i]        (hits: misses avoided)
    miss penalty avoided per selected item   = n_ts            (first term)
    false-positive cost incurred             = λ·(N_t·|item| − n_ts)
    value_ts = n_ts − λ·(N_t·|item| − n_ts)
  weight_ts = N_t·|item| / N    (contribution to the average label size L̄)

Greedy (paper §Optimization): sort items by value/weight ratio, take while
Σ weight ≤ B and value > 0. This is the classic fractional-knapsack greedy,
exactly as the paper prescribes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def candidate_stats(assign: np.ndarray, topk_ids: np.ndarray, r: int, L: int,
                    block: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Hit counts per (cluster, item).

    assign: (N,) cluster of each context; topk_ids: (N, k) exact top-k words.
    Returns (counts (r, n_items) float64, cluster_sizes (r,)). With block > 1
    the vocab is partitioned into ceil(L/block) items.
    """
    N, k = topk_ids.shape
    n_items = -(-L // block)
    items = topk_ids // block if block > 1 else topk_ids
    counts = np.zeros((r, n_items), np.float64)
    flat_cluster = np.repeat(assign, k)
    np.add.at(counts, (flat_cluster, items.reshape(-1)), 1.0)
    cluster_sizes = np.bincount(assign, minlength=r).astype(np.float64)
    return counts, cluster_sizes


def greedy_knapsack(counts: np.ndarray, cluster_sizes: np.ndarray, N: int,
                    budget: float, lamb: float, L: int,
                    block: int = 1) -> np.ndarray:
    """Solve the c-step. Returns boolean mask (r, n_items).

    budget: B — max average candidate size in WORDS (so block items weigh
    block× more).
    """
    r, n_items = counts.shape
    Ns = cluster_sizes[:, None]                       # (r, 1)
    item_words = float(block)
    value = counts - lamb * (Ns * item_words - counts)
    weight = np.broadcast_to(Ns * item_words / max(N, 1), counts.shape)

    flat_v = value.reshape(-1)
    flat_w = weight.reshape(-1)
    ratio = np.where(flat_w > 0, flat_v / np.maximum(flat_w, 1e-12), -np.inf)
    order = np.argsort(-ratio, kind="stable")

    mask = np.zeros(r * n_items, bool)
    cum = 0.0
    for idx in order:
        if flat_v[idx] <= 0:
            break                                    # ratios only get worse
        w = flat_w[idx]
        if w <= 0:
            continue                                 # empty cluster: free but useless
        if cum + w > budget:
            continue                                 # try smaller items further down
        mask[idx] = True
        cum += w
    return mask.reshape(r, n_items)
