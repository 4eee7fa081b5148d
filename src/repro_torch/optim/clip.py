"""Global-norm gradient clipping. Twin of ``repro/optim/clip.py``."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_flatten, tree_unflatten


def clip_by_global_norm(grads, max_norm: float):
    """→ (grads scaled to a global norm ≤ ``max_norm``, the norm before).
    Leaves are summed in the reference's order (``tree_flatten``)."""
    leaves = tree_flatten(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    return tree_unflatten(grads, [(g * scale).to(g.dtype) for g in leaves]), gnorm
