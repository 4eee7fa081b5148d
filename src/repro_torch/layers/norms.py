"""RMSNorm / LayerNorm. Twin of ``repro/layers/norms.py``: params are dicts
of tensors, statistics are computed in float32."""
from __future__ import annotations

import torch


def norm_init(d_model: int, kind: str, dtype=torch.float32, device=None):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d_model,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d_model,), dtype=dtype, device=device),
                "bias": torch.zeros((d_model,), dtype=dtype, device=device)}
    raise ValueError(kind)


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * (1.0 / torch.sqrt(var + eps))
    return (y * params["scale"].float()).to(dtype)


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) / torch.sqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dtype)


def norm_apply(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)
