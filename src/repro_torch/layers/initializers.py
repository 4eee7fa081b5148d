"""Parameter initializers. Twin of ``repro/layers/initializers.py``; draws
come from an explicit ``torch.Generator`` (not JAX's bits), and tensors are
made on the generator's device: a CPU generator gives the same weights on
any device, a CUDA one draws a full-width model on the card."""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               scale: Optional[float] = None,
               stack: Optional[int] = None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init: std = scale, else 1/√fan_in.

    ``stack``: draw that many layers at once, as a leading axis; the fan-in
    is the one of ``shape`` (one layer's matrix)."""
    fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else (shape[0] if shape else 1)
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    full = tuple(shape) if stack is None else (stack, *shape)
    t = torch.empty(full, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(dtype)
