"""Multi-layer LSTM language model — the paper's own architecture (§4).

Twin of ``repro/layers/lstm.py``, in its fused-gate layout: gates = x·Wx +
h·Wh + b, split into (i, f, g, o), forget-gate bias 1. The products are
``torch.matmul`` (IEEE float32 on a GPU, see ``repro_torch.device``), not
``nn.LSTM``/cuDNN, whose weight layout and TF32 default would break parity
with the reference. Prefill is a Python loop over time.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers.attention import matmul
from repro_torch.layers.initializers import dense_init
from repro_torch.utils.shard import gathered


def lstm_init(generator: torch.Generator, cfg: ModelConfig,
              dtype=torch.float32):
    d = cfg.d_model
    layers = []
    for _ in range(cfg.num_layers):
        b = torch.zeros((4 * d,), dtype=dtype)
        b[d:2 * d] = 1.0                                  # forget-gate bias 1
        layers.append({"wx": dense_init(generator, (d, 4 * d), dtype),
                       "wh": dense_init(generator, (d, 4 * d), dtype),
                       "b": b})
    return {"layers": layers}


def _cell(p, x, h, c):
    # a state in another dtype than the weights (a bfloat16 decode cache
    # of a float32 model, as the dry run gives it) is promoted, as JAX
    # promotes it in the reference
    # on a mesh the gate dim is gathered once, for its split, and its
    # gradient split again before the weights' products
    gates = gathered(matmul(x, p["wx"]) + matmul(h, p["wh"]) + p["b"])
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device="cuda") -> List[dict]:
    """Zero (h, c) per layer on ``device`` (default the card; raises
    without a GPU unless ``device="cpu"``)."""
    dev = resolve_device(device)
    d = cfg.d_model
    return [{"h": torch.zeros((batch, d), dtype=dtype, device=dev),
             "c": torch.zeros((batch, d), dtype=dtype, device=dev)}
            for _ in range(cfg.num_layers)]


def lstm_forward(params, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[List[dict]] = None
                 ) -> Tuple[torch.Tensor, List[dict]]:
    """x: (B, T, d) embedded inputs → (hidden (B, T, d), final state)."""
    B, T, _ = x.shape
    if state is None:
        state = lstm_init_state(cfg, B, x.dtype, x.device)
    out = x
    new_state = []
    for li, p in enumerate(params["layers"]):
        h, c = state[li]["h"], state[li]["c"]
        ys = []
        for t in range(T):
            h, c = _cell(p, out[:, t], h, c)
            ys.append(h)
        out = torch.stack(ys, dim=1)
        new_state.append({"h": h, "c": c})
    return out, new_state


def lstm_decode_step(params, x1: torch.Tensor, state: List[dict],
                     cfg: ModelConfig) -> Tuple[torch.Tensor, List[dict]]:
    """x1: (B, d) one embedded token → (h_top (B, d), new state)."""
    out = x1
    new_state = []
    for li, p in enumerate(params["layers"]):
        h, c = _cell(p, out, state[li]["h"], state[li]["c"])
        new_state.append({"h": h, "c": c})
        out = h
    return out, new_state
