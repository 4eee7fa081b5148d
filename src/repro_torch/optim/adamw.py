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
from repro_torch.utils import shard


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


# elements of a leaf updated at once: an update's temporaries stay this
# small (64 MB each in float32), whatever the leaf's size
SLICE = 1 << 24


def adamw_update(grads, state: AdamWState, params, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, donate: bool = False):
    """→ (new_params, new_state). ``lr`` is a float or a 0-dim tensor (a
    schedule's value). With ``donate`` the params and moments are updated
    in place (the returned trees hold the same tensors), as a caller that
    gives them up lets XLA reuse donated buffers; else new tensors are
    made. Either way each leaf is updated in slices of ``SLICE`` elements,
    every element's arithmetic in the order the module docstring gives.
    A DTensor leaf is updated on each device's shard, at the param's
    placements (its gradient redistributed to them first)."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def leaf(g, m, v, p, bc1, bc2, lr):
        new = ((lambda x: x) if donate else
               (lambda x: torch.empty(x.shape, dtype=x.dtype,
                                      device=x.device)))
        np_, nm, nv = new(p), new(m), new(v)
        g, m, v, p = (x.reshape(-1) for x in (g, m, v, p))
        fp, fm, fv = (x.view(-1) for x in (np_, nm, nv))
        for a in range(0, g.numel(), SLICE):
            i = slice(a, a + SLICE)
            g32 = g[i].float()
            torch.add(m[i] * b1, g32 * (1.0 - b1), out=fm[i])
            torch.add(v[i] * b2, torch.square(g32).mul_(1.0 - b2), out=fv[i])
            delta = torch.div(fm[i], bc1).div_(
                torch.div(fv[i], bc2).sqrt_().add_(eps))
            delta.add_(p[i].float() * weight_decay).mul_(lr)
            if fp.dtype == torch.float32:
                torch.sub(p[i], delta, out=fp[i])
            else:
                fp[i].copy_(p[i].float() - delta)
        return np_, nm, nv

    out_p, out_m, out_v = [], [], []
    for g, m, v, p in zip(tree_flatten(grads), tree_flatten(state.mu),
                          tree_flatten(state.nu), tree_flatten(params)):
        if shard.is_dtensor(p):
            pl = tuple(p.placements)
            np_, nm, nv = shard.per_device(
                leaf, (g, m, v, p, bc1, bc2, lr), (pl, pl, pl, pl, None,
                                                   None, None), (pl,) * 3)
        else:
            np_, nm, nv = leaf(g, m, v, p, bc1, bc2, lr)
        out_p.append(np_)
        out_m.append(nm)
        out_v.append(nv)
    return tree_unflatten(params, out_p), AdamWState(
        step=step, mu=tree_unflatten(params, out_m),
        nu=tree_unflatten(params, out_v))
