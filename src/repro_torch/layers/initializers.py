"""Parameter initializers. Twin of ``repro/layers/initializers.py``; draws
come from an explicit ``torch.Generator`` (not JAX's bits), and tensors are
made on the generator's device: a CPU generator gives the same weights on
any device, a CUDA one draws a full-width model on the card. With no
generator (``None``) nothing is drawn: the tensors are made on the ``meta``
device, shapes and dtypes only (``Model.init(..., device="meta")``)."""
from __future__ import annotations

import math
from typing import Optional

import torch

META = torch.device("meta")


def init_device(generator: Optional[torch.Generator]) -> torch.device:
    """Where an init draws: the generator's device, or ``meta`` for None."""
    return META if generator is None else generator.device


def dense_init(generator: Optional[torch.Generator], shape, dtype=torch.float32,
               scale: Optional[float] = None,
               stack: Optional[int] = None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init: std = scale, else 1/√fan_in.

    ``stack``: draw that many layers at once, as a leading axis; the fan-in
    is the one of ``shape`` (one layer's matrix)."""
    fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else (shape[0] if shape else 1)
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    full = tuple(shape) if stack is None else (stack, *shape)
    if generator is None:
        return torch.empty(full, dtype=dtype, device=META)
    t = torch.empty(full, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(dtype)
