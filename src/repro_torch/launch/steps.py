"""The LM train step. Twin of ``repro/launch/steps.py::make_train_step``,
for every family (lstm, dense, moe, ssm, hybrid, vlm, audio; a moe model's
loss carries its load-balance aux, ``models/lm.py::train_loss``).

Forward and backward run through ``torch.autograd`` over the port's torch
layers (float32 products stay IEEE float32: ``resolve_device`` turns TF32
off); on the card the SSM layers' intra-chunk terms run through
``kernels/ssd.py``'s kernels, forward and backward. The reference's prefill
and serve steps and its abstract shapes belong to its XLA dry-run and are
not ported (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.lm import train_loss
from repro_torch.models.model import Model
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               cosine_schedule)
from repro_torch.tree import tree_flatten, tree_unflatten


def loss_and_grads(model: Model, tcfg: TrainConfig, params,
                   batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, dict]:
    """(mean loss, float32 gradients as a params tree) of one global batch;
    ``tcfg.microbatch = m`` splits it into m sequential microbatches whose
    losses and gradients are summed, then divided by m."""
    leaves = tree_flatten(params)

    def one(mb) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = train_loss(model, tree_unflatten(params, live), mb,
                              loss_chunk=tcfg.loss_chunk,
                              remat=(tcfg.remat == "block"))
            # a leaf the loss does not read (the audio encoder's token
            # embedding) gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(live, grads)]

    m = tcfg.microbatch
    if m is None or m <= 1:
        loss, grads = one(batch)
    else:
        n = next(iter(batch.values())).shape[0] // m
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        for i in range(m):
            l, g = one({k: x[i * n:(i + 1) * n] for k, x in batch.items()})
            loss = loss + l
            grads = [a + b.float() for a, b in zip(grads, g)]
        loss = loss / m
        grads = [g / m for g in grads]
    return loss, tree_unflatten(params, grads)


def make_train_step(model: Model, tcfg: TrainConfig, donate: bool = False):
    """fwd + bwd + global-norm clip + AdamW: ``train_step(params, opt_state,
    batch) → (params, opt_state, {"loss", "gnorm"})``, the batch a dict of
    tensors on the params' device. ``donate=True`` updates ``params`` and
    ``opt_state``'s moments in place (the caller gives them up, as to a
    jitted step with donated buffers): a float32 zamba2-2.7b step then holds
    one copy of params and moments (3 × 9.26 GB) instead of old and new
    ones."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, tcfg, params, batch)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        # schedule off the 1-based step (the 0-based pre-update counter would
        # make the first step a warmup no-op)
        lr = cosine_schedule(opt_state.step + 1, tcfg.lr, tcfg.warmup_steps,
                             tcfg.total_steps)
        params, opt_state = adamw_update(grads, opt_state, params, lr,
                                         tcfg.b1, tcfg.b2,
                                         weight_decay=tcfg.weight_decay,
                                         donate=donate)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}
    return train_step
