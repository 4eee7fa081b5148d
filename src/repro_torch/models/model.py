"""Model wrapper, LSTM family. Twin of ``repro/models/model.py``.

Params are plain dicts of tensors with the reference's layout:
``{"embed": {embedding, lm_head, lm_bias}, "lstm": {"layers": [{wx, wh, b}]}}``
(``repro_torch.interop.params_from_numpy`` converts the reference's).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers.embeddings import (embed_init, embed_tokens,
                                          head_matrix, lm_logits)
from repro_torch.layers.lstm import (lstm_decode_step, lstm_forward,
                                     lstm_init, lstm_init_state)


class Model:
    """Functional model wrapper (params are plain dicts of tensors)."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "lstm":
            raise NotImplementedError(
                f"{cfg.name}: repro_torch ports only the lstm family so far "
                f"(got {cfg.family!r}; see ROADMAP.md, Queue 1)")
        self.cfg = cfg

    def init(self, generator: torch.Generator,
             device="cuda") -> Dict[str, Any]:
        """Random weights drawn from ``generator`` (a CPU generator) in
        ``cfg.dtype`` and placed on ``device``: the same weights on any
        device."""
        dev = resolve_device(device)
        dtype = getattr(torch, self.cfg.dtype)
        params = {"embed": embed_init(generator, self.cfg, dtype),
                  "lstm": lstm_init(generator, self.cfg, dtype)}
        return to_device(params, dev)

    def forward(self, params, batch: Dict[str, torch.Tensor]):
        """→ (h (B, T, d), aux loss 0.0)."""
        x = embed_tokens(params["embed"], batch["tokens"])
        h, _ = lstm_forward(params["lstm"], x, self.cfg)
        return h, 0.0

    def logits(self, params, h) -> torch.Tensor:
        return lm_logits(params["embed"], h, self.cfg)

    def softmax_weights(self, params):
        """(W (V, d), b (V,)) — the matrix/bias the paper's screening targets."""
        return head_matrix(params["embed"], self.cfg), params["embed"]["lm_bias"]

    def init_cache(self, batch: int, dtype=torch.float32, device="cpu"):
        """Recurrent state only: an LSTM's cache does not grow with the
        sequence."""
        return {"lstm": lstm_init_state(self.cfg, batch, dtype, device)}

    def prefill(self, params, batch, cache, resume: bool = False):
        """Forward over the prompt AND prime the decode cache.

        ``resume=True`` continues from ``cache``'s recurrent state instead
        of zeros: the same cell sequence, so resumed prefill over a suffix
        equals one-shot prefill over the full prompt. → (h (B, T, d), cache)."""
        x = embed_tokens(params["embed"], batch["tokens"])
        h, state = lstm_forward(params["lstm"], x, self.cfg,
                                state=cache["lstm"] if resume else None)
        return h, {"lstm": state}

    def decode_step(self, params, token, cache, pos=None):
        """token: (B,) int; ``pos`` is unused by the recurrent state.
        → (h (B, d), cache)."""
        x1 = embed_tokens(params["embed"], token)
        h, new_state = lstm_decode_step(params["lstm"], x1, cache["lstm"],
                                        self.cfg)
        return h, {"lstm": new_state}


def to_device(tree, device):
    """Every tensor of a nested dict/list moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree

