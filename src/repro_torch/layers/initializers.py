"""Parameter initializers. Twin of ``repro/layers/initializers.py``; draws
come from an explicit CPU ``torch.Generator`` (not JAX's bits)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init: std = scale, else 1/√fan_in."""
    fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else (shape[0] if shape else 1)
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.nn.init.trunc_normal_(torch.empty(shape, dtype=torch.float32),
                                    0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)
