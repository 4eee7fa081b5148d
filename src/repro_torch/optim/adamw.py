"""AdamW (decoupled weight decay) over params trees. Twin of
``repro/optim/adamw.py``.

State mirrors the params; the moments are float32 whatever the params' type.
The update keeps the reference's order of operations:
``p − lr·(m̂/(√v̂ + eps) + wd·p)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-dim int32, on the params' device
    mu: object
    nu: object


def adamw_init(params) -> AdamWState:
    leaves = tree_flatten(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def adamw_update(grads, state: AdamWState, params, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """→ (new_params, new_state). ``lr`` is a float or a 0-dim tensor (a
    schedule's value)."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(g, m, v, p):
        g32 = g.float()
        m = b1 * m + (1.0 - b1) * g32
        v = b2 * v + (1.0 - b2) * torch.square(g32)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_flatten(grads), tree_flatten(state.mu), tree_flatten(state.nu),
        tree_flatten(params))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v)
