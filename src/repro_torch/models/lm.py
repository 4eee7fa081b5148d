"""Training losses for the language models. Twin of ``repro/models/lm.py``.

On a mesh (vocab-split logits) log Z and the gold logit are taken
vocab-parallel (``utils/shard.py::logsumexp_last`` / ``gather_last``), as
GSPMD takes them; without one they are ``torch.logsumexp`` and
``torch.gather``."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.model import Model
from repro_torch.utils import shard


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-level mean xent. logits (B, T, V) any float; labels (B, T) int."""
    logits = logits.float()
    lse = shard.logsumexp_last(logits)
    gold = shard.gather_last(logits, labels.long())
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def train_loss(model: Model, params, batch: Dict[str, torch.Tensor],
               loss_chunk: Optional[int] = None,
               remat: bool = False) -> torch.Tensor:
    """Forward + next-token (or, for the audio encoder, masked-prediction)
    loss. The vlm's loss covers the text region only (h[:, P:]); the
    encoder's ``labels`` are its frames' unit targets.

    ``loss_chunk``: if set, the vocab logits and xent are computed in
    sequence chunks of this size, each under activation checkpointing, so
    the full (B, T, V) logits tensor never exists, in the forward pass or
    in the backward. ``remat`` checkpoints each layer (and super-block) of
    the dense, moe, SSM and hybrid stacks, as the reference's does; for the
    LSTM it is a no-op, as in the reference. A moe model's load-balance aux
    (summed over its layers) is added to the loss."""
    h, aux = model.forward(params, batch, remat=remat)
    if model.cfg.family == "vlm":
        h = h[:, batch["patches"].shape[1]:]
    labels = batch["labels"]
    if loss_chunk is None:
        return cross_entropy_loss(model.logits(params, h), labels) + aux

    B, T = labels.shape
    if T % loss_chunk:
        loss_chunk = math.gcd(T, loss_chunk)
    if loss_chunk <= 1:
        return cross_entropy_loss(model.logits(params, h), labels) + aux

    def chunk_nll(hi, li):
        logits = model.logits(params, hi).float()
        lse = shard.logsumexp_last(logits)
        gold = shard.gather_last(logits, li.long())
        return torch.sum(lse - gold)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, T, loss_chunk):
        hi, li = h[:, s:s + loss_chunk], labels[:, s:s + loss_chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(chunk_nll, hi, li, use_reentrant=False)
        else:
            total = total + chunk_nll(hi, li)
    return total / (B * T) + aux
