"""LR schedules as functions of the step (a tensor). Twin of
``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def linear_warmup(step: torch.Tensor, base_lr: float, warmup_steps: int
                  ) -> torch.Tensor:
    w = torch.clamp(step.float() / max(warmup_steps, 1), max=1.0)
    return base_lr * w


def cosine_schedule(step: torch.Tensor, base_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    s = step.float()
    warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos
