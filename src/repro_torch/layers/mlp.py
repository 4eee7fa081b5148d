"""MLP blocks: SwiGLU / GeGLU (gated) and GELU / ReLU (plain 2-matmul).
Twin of ``repro/layers/mlp.py``; the products are ``torch.matmul``, in the
wider dtype of activations and weights, as JAX's einsum promotes them."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.attention import matmul
from repro_torch.layers.initializers import dense_init

GATED = ("swiglu", "geglu")


def mlp_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             stack=None):
    """One layer's MLP, or ``stack`` layers' along a leading axis."""
    d, ff = cfg.d_model, cfg.d_ff
    kw = dict(stack=stack)
    if cfg.mlp_activation in GATED:
        return {"w_gate": dense_init(generator, (d, ff), dtype, **kw),
                "w_up": dense_init(generator, (d, ff), dtype, **kw),
                "w_down": dense_init(generator, (ff, d), dtype, **kw)}
    return {"w_up": dense_init(generator, (d, ff), dtype, **kw),
            "w_down": dense_init(generator, (ff, d), dtype, **kw)}


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = cfg.mlp_activation
    if act in GATED:
        g = matmul(x, params["w_gate"])
        u = matmul(x, params["w_up"])
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        return matmul(g * u, params["w_down"])
    u = matmul(x, params["w_up"])
    u = F.gelu(u, approximate="tanh") if act == "gelu" else F.relu(u)
    return matmul(u, params["w_down"])
