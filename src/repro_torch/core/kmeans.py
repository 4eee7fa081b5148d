"""Spherical k-means on context vectors — L2S initialization (Algorithm 1
l.3) and the Table-4 ablation baseline. Twin of ``repro/core/kmeans.py``."""
from __future__ import annotations

from typing import Optional

import torch


def _normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + eps)


def _maximin_init(Xn: torch.Tensor, r: int, first: int) -> torch.Tensor:
    """Farthest-point init: the first center is row ``first``, each next
    center the point least similar (cosine) to every center chosen so far
    (argmin: the first index wins a tie). Unlike uniform sampling this
    cannot seed two centers inside one tight cluster and strand another —
    the collapse mode of k-means on separable data."""
    c = Xn[first]
    centers = [c]
    maxsim = Xn @ c
    for _ in range(r - 1):
        c = Xn[torch.argmin(maxsim)]
        centers.append(c)
        maxsim = torch.maximum(maxsim, Xn @ c)
    return torch.stack(centers)


def spherical_kmeans(X: torch.Tensor, r: int,
                     generator: Optional[torch.Generator] = None,
                     iters: int = 20, first: Optional[int] = None
                     ) -> torch.Tensor:
    """Cluster rows of X (N, d) by cosine similarity into r clusters.

    ``first``: the row that seeds the maximin init, else drawn uniformly
    from ``generator``. Returns centers (r, d), unit rows; a cluster left
    empty keeps its previous center."""
    N, _ = X.shape
    Xn = _normalize(X.float())
    if first is None:
        first = int(torch.randint(N, (), generator=generator,
                                  device=generator.device if generator
                                  is not None else "cpu"))
    centers = _maximin_init(Xn, r, first)
    for _ in range(iters):
        assign = torch.argmax(Xn @ centers.T, dim=-1)
        onehot = torch.nn.functional.one_hot(assign, r).float()   # (N, r)
        sums = onehot.T @ Xn                                       # (r, d)
        counts = torch.sum(onehot, dim=0)[:, None]
        centers = torch.where(counts > 0, _normalize(sums), centers)
    return centers


def kmeans_assign(centers: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return torch.argmax(_normalize(X.float()) @ centers.T, dim=-1)
