"""Gumbel-softmax straight-through estimator (Jang et al. 2017), paper
Eq.(4-5). Twin of ``repro/core/gumbel.py``; the noise comes from a
``torch.Generator``, or ready-made from the caller."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def sample_gumbel(shape, generator: Optional[torch.Generator] = None,
                  eps: float = 1e-10, device=None) -> torch.Tensor:
    """Standard Gumbel noise −log(−log u), u uniform in [eps, 1 − eps) as
    the reference draws it, on ``device`` (default the generator's)."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    u = u * ((1.0 - eps) - eps) + eps
    return -torch.log(-torch.log(u))


def gumbel_softmax_st(logits: torch.Tensor, temperature: float = 1.0,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Straight-through Gumbel softmax.

    logits: (..., r) unnormalized log-probabilities log P(t|h) (paper
    Eq.(3)); ``noise``: Gumbel noise of the logits' shape, else drawn from
    ``generator``. Returns (p_bar, p_soft): p_bar is one-hot in value with
    p_soft's gradient (p̄ = p + stop_grad(one_hot(argmax p) − p)); p_soft is
    Eq.(5). The argmax takes the first index on a tie, as the reference's.
    """
    if noise is None:
        noise = sample_gumbel(logits.shape, generator, device=logits.device)
    y = (logits.float() + noise) / temperature
    p_soft = torch.softmax(y, dim=-1)
    hard = torch.nn.functional.one_hot(torch.argmax(p_soft, dim=-1),
                                       logits.shape[-1]).to(p_soft.dtype)
    p_bar = p_soft + (hard - p_soft).detach()
    return p_bar, p_soft
