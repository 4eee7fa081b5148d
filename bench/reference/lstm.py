"""Plain reference of the ``lstm`` family (the paper's 2-layer LSTM LM):
its weights and its full forward pass, in plain PyTorch, float32.

Per layer, gates = x·Wx + h·Wh + b split into (i, f, g, o);
c ← σ(f)·c + σ(i)·tanh(g); h ← σ(o)·tanh(c). Inputs are the embedding
rows of the tokens; the logits are W·h + b over the vocabulary, W the
output matrix (``lm_head``, or the embedding when tied). No cache, no
batching beyond running rows side by side, no kernel. Imports nothing of
the program. ``model_flops`` counts what the forward pass multiplies.
"""
from __future__ import annotations

import math

import torch

FAMILY = "lstm"


def param_spec(cfg: dict) -> list:
    """[(path, shape, dtype, rule)] of every weight (``l2sbench.weights``)."""
    d, V, dt = int(cfg["d_model"]), int(cfg["vocab_size"]), cfg["dtype"]
    spec = [(("embed", "embedding"), (V, d), dt, ("normal", 0.02))]
    if not cfg["tie_embeddings"]:
        spec.append((("embed", "lm_head"), (V, d), dt, ("normal", 0.02)))
    spec.append((("embed", "lm_bias"), (V,), dt, ("zeros",)))
    for i in range(int(cfg["num_layers"])):
        std = 1.0 / math.sqrt(d)
        layer = ("lstm", "layers", i)
        spec += [(layer + ("wx",), (d, 4 * d), dt, ("normal", std)),
                 (layer + ("wh",), (d, 4 * d), dt, ("normal", std)),
                 (layer + ("b",), (4 * d,), dt, ("forget_bias", d))]
    return spec


def head(w: dict, cfg: dict):
    """(W (V, d), b (V,)) of the softmax."""
    W = w[("embed", "embedding")] if cfg["tie_embeddings"] \
        else w[("embed", "lm_head")]
    return W, w[("embed", "lm_bias")]


def hidden(w: dict, cfg: dict, tokens: torch.Tensor, prec) -> torch.Tensor:
    """tokens (B, T) → the top layer's h (B, T, d), float32, every product
    through ``prec.mm``."""
    x = w[("embed", "embedding")][tokens.long()].float()
    B, T, d = x.shape
    for i in range(int(cfg["num_layers"])):
        wx = w[("lstm", "layers", i, "wx")].float()
        wh = w[("lstm", "layers", i, "wh")].float()
        b = w[("lstm", "layers", i, "b")].float()
        xw = prec.mm(x.reshape(B * T, d), wx).reshape(B, T, 4 * d) + b
        h = x.new_zeros((B, d))
        c = x.new_zeros((B, d))
        ys = []
        for t in range(T):
            gi, gf, gg, go = (xw[:, t] + prec.mm(h, wh)).chunk(4, dim=-1)
            c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(c)
            ys.append(h)
        x = torch.stack(ys, dim=1)
    return x


def model_flops(cfg: dict, start: int, stop: int) -> float:
    """FLOPs of the model (no head) over positions [start, stop) of one
    sequence: 2 per multiply-add of x·Wx and h·Wh in every layer."""
    d, L = int(cfg["d_model"]), int(cfg["num_layers"])
    return float(max(stop - start, 0) * L * 2 * (2 * d * 4 * d))
