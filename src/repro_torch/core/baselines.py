"""Competing algorithms from paper §4.1, for Table 1 / Figs 2-4. A numpy
copy of ``repro/core/baselines.py``: the same inputs and seeds give the same
ids. These are host algorithms, timed one query at a time on one CPU thread
as the paper times them.

All operate on the same (W (L, d), b (L,)) softmax layer and context vectors
H, and return top-k ids so precision_at_k applies uniformly.

  * SVD-softmax (Shim et al. 2017): rank-ρ preview logits for ALL words,
    exact rerank of the top-Ñ preview candidates.
  * Adaptive-softmax-style shortlist (Grave et al. 2017, inference use): a
    frequency-ordered head cluster of size n_head + tail clusters; if the
    top-k of [head words ∪ tail-cluster logits] stay inside the head, done,
    else descend into the predicted tail cluster.
  * Greedy-MIPS (Yu et al. 2017): budgeted screening by per-dimension
    rankings of W, exact rerank of the screened pool.
  * LSH-MIPS (Neyshabur & Srebro 2015): MIPS→NNS reduction (augment with
    sqrt(M²−‖w‖²)), SimHash bands, bucket candidates, exact rerank.
  * PCA-MIPS (Bachrach et al. 2014): same reduction, PCA-tree with median
    splits; route query to a leaf, exact rerank within the leaf.

FLOP accounting: every method reports `flops_per_query` so the speedup column
is hardware-independent (wall-clock is also measured in the benchmark).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


# -- SVD-softmax ---------------------------------------------------------------

@dataclass
class SVDSoftmax:
    U: np.ndarray       # (L, rho)
    SVt: np.ndarray     # (rho, d)
    W: np.ndarray
    b: np.ndarray
    rho: int
    n_top: int

    @classmethod
    def build(cls, W, b, rho: int, n_top: int):
        U, S, Vt = np.linalg.svd(W, full_matrices=False)
        return cls(U=(U[:, :rho] * S[:rho]).astype(np.float32),
                   SVt=Vt[:rho].astype(np.float32),
                   W=W, b=b, rho=rho, n_top=n_top)

    def topk(self, H: np.ndarray, k: int) -> np.ndarray:
        q = H @ self.SVt.T                                  # (N, rho)
        preview = q @ self.U.T + self.b                     # (N, L)
        L = preview.shape[1]
        if self.n_top >= L:
            cand = np.broadcast_to(np.arange(L), preview.shape)
        else:
            cand = np.argpartition(-preview, self.n_top, axis=1)[:, :self.n_top]
        out = np.empty((H.shape[0], k), np.int64)
        for i in range(H.shape[0]):
            c = cand[i]
            ex = self.W[c] @ H[i] + self.b[c]
            out[i] = c[np.argsort(-ex)[:k]]
        return out

    @property
    def flops_per_query(self) -> float:
        L, d = self.W.shape
        return d * self.rho + L * self.rho + self.n_top * d


# -- Adaptive-softmax-style frequent shortlist ----------------------------------

@dataclass
class AdaptiveShortlist:
    head_ids: np.ndarray      # (n_head,) most frequent words
    tails: list               # list of np arrays of word ids
    W: np.ndarray
    b: np.ndarray

    @classmethod
    def build(cls, W, b, freq_order: np.ndarray, n_head: int, n_tails: int = 4):
        head = freq_order[:n_head]
        rest = freq_order[n_head:]
        # drop empty tails (n_head may cover the whole vocab → head-only)
        tails = [t for t in np.array_split(rest, n_tails) if len(t)]
        return cls(head_ids=head, tails=tails, W=W, b=b)

    def topk(self, H: np.ndarray, k: int) -> np.ndarray:
        Wh = self.W[self.head_ids]
        bh = self.b[self.head_ids]
        if not self.tails:                   # head covers the vocab: exact
            lg = H @ Wh.T + bh
            top = np.argsort(-lg, axis=1)[:, :k]
            got = self.head_ids[top]
            if got.shape[1] < k:             # k > head size: pad missing
                pad = np.full((got.shape[0], k - got.shape[1]), -1, np.int64)
                got = np.concatenate([got, pad], axis=1)
            return got
        # tail "cluster logits" = mean tail vector (one pseudo-word per tail)
        tW = np.stack([self.W[t].mean(axis=0) for t in self.tails])
        tb = np.array([self.b[t].mean() for t in self.tails])
        out = np.full((H.shape[0], k), -1, np.int64)
        for i in range(H.shape[0]):
            hl = Wh @ H[i] + bh
            tl = tW @ H[i] + tb
            # k ≥ head size: the head alone cannot fill top-k — descend
            if k < len(hl) and hl[np.argpartition(-hl, k)[:k]].min() >= tl.max():
                top = np.argsort(-hl)[:k]
                out[i] = self.head_ids[top]
            else:
                t = int(np.argmax(tl))
                ids = np.concatenate([self.head_ids, self.tails[t]])
                lg = self.W[ids] @ H[i] + self.b[ids]
                top = ids[np.argsort(-lg)[:k]]
                out[i, :len(top)] = top
        return out

    def flops_per_query(self, descend_rate: float) -> float:
        d = self.W.shape[1]
        n_head = len(self.head_ids)
        tail = np.mean([len(t) for t in self.tails]) if self.tails else 0.0
        return (n_head + len(self.tails)) * d + descend_rate * tail * d


# -- Greedy-MIPS (budgeted) ------------------------------------------------------

@dataclass
class GreedyMIPS:
    order: np.ndarray    # (d, L) word ids sorted by coordinate value desc
    W: np.ndarray
    b: np.ndarray
    budget: int

    @classmethod
    def build(cls, W, b, budget: int):
        order = np.argsort(-W, axis=0).T.astype(np.int32)   # (d, L)
        return cls(order=order, W=W, b=b, budget=budget)

    def topk(self, H: np.ndarray, k: int) -> np.ndarray:
        out = np.empty((H.shape[0], k), np.int64)
        d = self.W.shape[1]
        per_dim = max(1, self.budget // max(1, min(d, 32)))
        for i in range(H.shape[0]):
            h = H[i]
            dims = np.argsort(-np.abs(h))[:min(d, 32)]
            pool = []
            for j in dims:
                lst = self.order[j][:per_dim] if h[j] > 0 else self.order[j][-per_dim:]
                pool.append(lst)
            cand = np.unique(np.concatenate(pool))
            lg = self.W[cand] @ h + self.b[cand]
            out[i] = cand[np.argsort(-lg)[:k]] if len(cand) >= k else np.pad(
                cand[np.argsort(-lg)], (0, k - len(cand)), constant_values=-1)
        return out

    @property
    def flops_per_query(self) -> float:
        return self.budget * self.W.shape[1]


# -- LSH-MIPS ---------------------------------------------------------------------

def _augment_db(W):
    norms = np.linalg.norm(W, axis=1)
    M = norms.max()
    aug = np.sqrt(np.maximum(M * M - norms * norms, 0.0))
    return np.concatenate([W, aug[:, None]], axis=1), M


@dataclass
class LSHMIPS:
    planes: np.ndarray        # (bands, bits, d+1)
    tables: list              # per band: dict code → word ids
    W: np.ndarray
    b: np.ndarray

    @classmethod
    def build(cls, W, b, bands: int = 8, bits: int = 10, seed: int = 0):
        Wa, M = _augment_db(W)
        rng = np.random.default_rng(seed)
        planes = rng.standard_normal((bands, bits, Wa.shape[1])).astype(np.float32)
        tables = []
        for bi in range(bands):
            codes = (Wa @ planes[bi].T > 0).astype(np.uint64)
            key = codes @ (1 << np.arange(bits, dtype=np.uint64))
            tbl = {}
            for wid, kk in enumerate(key):
                tbl.setdefault(int(kk), []).append(wid)
            tables.append({kk: np.array(v, np.int32) for kk, v in tbl.items()})
        return cls(planes=planes, tables=tables, W=W, b=b)

    def topk(self, H: np.ndarray, k: int) -> np.ndarray:
        Ha = np.concatenate([H, np.zeros((H.shape[0], 1), H.dtype)], axis=1)
        out = np.full((H.shape[0], k), -1, np.int64)
        weights = (1 << np.arange(self.planes.shape[1], dtype=np.uint64))
        for i in range(H.shape[0]):
            pool = []
            for bi in range(self.planes.shape[0]):
                code = int(((Ha[i] @ self.planes[bi].T > 0).astype(np.uint64) @ weights))
                pool.append(self.tables[bi].get(code, np.empty(0, np.int32)))
            cand = np.unique(np.concatenate(pool)) if pool else np.empty(0, np.int32)
            if len(cand) == 0:
                continue
            lg = self.W[cand] @ H[i] + self.b[cand]
            top = cand[np.argsort(-lg)[:k]]
            out[i, :len(top)] = top
        return out


# -- PCA-MIPS (PCA-tree) -------------------------------------------------------------

@dataclass
class PCAMIPS:
    dirs: np.ndarray        # (depth, d+1) split directions (principal components)
    thresholds: dict        # node id → median threshold
    leaves: dict            # leaf id → word ids
    depth: int
    W: np.ndarray
    b: np.ndarray

    @classmethod
    def build(cls, W, b, depth: int = 6):
        Wa, M = _augment_db(W)
        X = Wa - Wa.mean(axis=0)
        _, _, Vt = np.linalg.svd(X[:min(len(X), 5000)], full_matrices=False)
        dirs = Vt[:depth].astype(np.float32)
        thresholds, leaves = {}, {}

        def split(node, ids, level):
            if level == depth:
                leaves[node] = ids
                return
            proj = Wa[ids] @ dirs[level]
            med = float(np.median(proj))
            thresholds[node] = med
            split(node * 2 + 1, ids[proj <= med], level + 1)
            split(node * 2 + 2, ids[proj > med], level + 1)

        split(0, np.arange(len(W), dtype=np.int32), 0)
        return cls(dirs=dirs, thresholds=thresholds, leaves=leaves,
                   depth=depth, W=W, b=b)

    def topk(self, H: np.ndarray, k: int) -> np.ndarray:
        Ha = np.concatenate([H, np.zeros((H.shape[0], 1), H.dtype)], axis=1)
        out = np.full((H.shape[0], k), -1, np.int64)
        for i in range(H.shape[0]):
            node, level = 0, 0
            while level < self.depth:
                med = self.thresholds[node]
                node = node * 2 + (1 if Ha[i] @ self.dirs[level] <= med else 2)
                level += 1
            cand = self.leaves[node]
            if len(cand) == 0:
                continue
            lg = self.W[cand] @ H[i] + self.b[cand]
            top = cand[np.argsort(-lg)[:k]]
            out[i, :len(top)] = top
        return out
