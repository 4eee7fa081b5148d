"""Model wrapper over every family of the reference: ``lstm``, ``dense``,
``moe``, ``ssm`` (mamba2), ``hybrid`` (zamba2), ``vlm`` (qwen2-vl-2b) and
``audio`` (hubert-xlarge). Twin of ``repro/models/model.py``.

Params are plain dicts of tensors with the reference's layout (LSTM:
``{"embed", "lstm": {"layers": [...]}}``; the others: ``{"embed",
"stack": {"blocks" (stacked, leading L axis), "final_norm", "shared"}}``,
plus ``vision_proj`` (vlm) or ``frame_proj`` (audio), a (d, d) matrix);
``repro_torch.interop.params_from_numpy`` converts the reference's.

The vlm batch is ``{"tokens" (B, T), "patches" (B, P, d)}``: the stub
vision frontend's patch embeddings, projected and put before the text, with
M-RoPE positions (``layers/rope.py::mrope_positions``). The audio batch is
``{"frames" (B, T, d)}``, projected, plus float32 sinusoids, through the
bidirectional encoder; it has no decode (``init_cache`` raises).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers.attention import matmul
from repro_torch.layers.embeddings import (embed_init, embed_tokens,
                                          head_matrix, lm_logits)
from repro_torch.layers.initializers import dense_init
from repro_torch.layers.lstm import (lstm_decode_step, lstm_forward,
                                     lstm_init, lstm_init_state)
from repro_torch.layers.rope import mrope_positions
from repro_torch.layers.transformer import (STACK_FAMILIES, stack_decode,
                                            stack_decode_paged,
                                            stack_forward, stack_init,
                                            stack_init_cache, stack_prefill)
from repro_torch.tree import tree_map
from repro_torch.utils.shard import by_rows

FAMILIES = ("lstm",) + STACK_FAMILIES


class Model:
    """Functional model wrapper (params are plain dicts of tensors)."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        self.cfg = cfg

    def init(self, generator: Optional[torch.Generator], device="cuda",
             dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """Random weights drawn from ``generator`` and placed on ``device``,
        in ``dtype or cfg.dtype`` as the reference's ``Model.init`` takes
        them: bfloat16 for mamba2-1.3b and zamba2-2.7b, float32 for the
        LSTMs. The SSM layers' A_log, D and dt_bias stay float32 either way,
        as the reference keeps them; the dense, moe, vlm and audio configs
        are bfloat16 too. A CPU generator gives the same weights on any
        device; a CUDA generator draws them on the card (the fast way to a
        full-width model). On ``device="meta"`` nothing is drawn (the
        generator may be None): every leaf is a meta tensor of its shape
        and dtype, which is how the dry run holds qwen1.5-110b."""
        dev = resolve_device(device)
        if dev.type == "meta":
            generator = None
        cfg = self.cfg
        dtype = dtype or getattr(torch, cfg.dtype)
        params = {"embed": embed_init(generator, cfg, dtype)}
        if cfg.family == "lstm":
            params["lstm"] = lstm_init(generator, cfg, dtype)
        else:
            params["stack"] = stack_init(generator, cfg, dtype)
        if cfg.family == "vlm":
            # projector from the (stub) vision embeddings to the LM width
            params["vision_proj"] = dense_init(
                generator, (cfg.d_model, cfg.d_model), dtype)
        if cfg.family == "audio":
            params["frame_proj"] = dense_init(
                generator, (cfg.d_model, cfg.d_model), dtype)
        return to_device(params, dev)

    def _vlm_input(self, params, batch):
        """The vlm's prompt: projected patches (cast to the embeddings'
        dtype) then the text embeddings → (x (B, P + T, d), positions
        (B, P + T, 3))."""
        tok = embed_tokens(params["embed"], batch["tokens"])
        pat = matmul(batch["patches"], params["vision_proj"])
        x = torch.cat([pat.to(tok.dtype), tok], dim=1)
        P, T = pat.shape[1], tok.shape[1]
        return x, by_rows(lambda B: mrope_positions(B, P, T, device=x.device),
                          x)

    def forward(self, params, batch: Dict[str, torch.Tensor],
                remat: bool = False):
        """→ (h (B, T, d), aux loss: the moe layers' summed load-balance
        loss, a float32 tensor; 0.0 for the other families). ``remat``
        checkpoints the stacks' layers (and the hybrid's super-blocks; the
        LSTM has none). A vlm batch gives h over the patches and the text
        (B, P + T, d); an audio batch, in the frames' dtype promoted with
        the weights' (float32 frames give float32 h with bf16 weights, as
        JAX's promotion does in the reference)."""
        cfg = self.cfg
        if cfg.family == "audio":
            x = matmul(batch["frames"], params["frame_proj"])
            x = x + _sinusoidal(x.shape[1], cfg.d_model, x.dtype, x.device)
            return stack_forward(params["stack"], x, cfg, remat=remat)
        if cfg.family == "vlm":
            x, positions = self._vlm_input(params, batch)
            return stack_forward(params["stack"], x, cfg, positions,
                                 remat=remat)
        x = embed_tokens(params["embed"], batch["tokens"])
        if cfg.family == "lstm":
            h, _ = lstm_forward(params["lstm"], x, cfg)
            return h, 0.0
        return stack_forward(params["stack"], x, cfg, remat=remat)

    def logits(self, params, h) -> torch.Tensor:
        return lm_logits(params["embed"], h, self.cfg)

    def softmax_weights(self, params):
        """(W (V, d), b (V,)) — the matrix/bias the paper's screening targets."""
        return head_matrix(params["embed"], self.cfg), params["embed"]["lm_bias"]

    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   dtype=torch.bfloat16, device="cuda"):
        """Decode cache for ``batch`` rows on ``device`` (default the card;
        raises without a GPU unless ``device="cpu"``), ``dtype`` bfloat16
        by default as in the reference. LSTM: the recurrent state in
        ``dtype``, which does not grow with the sequence (``max_len``
        unused). Dense and moe: each layer's K/V caches of ``max_len`` slots
        in ``dtype`` — of ``sliding_window`` slots, a ring buffer, for a
        windowed config (mixtral-8x7b), whatever ``max_len`` is. SSM/hybrid: stacked float32 conv tails and SSM states,
        plus the shared block's K/V caches of ``max_len`` slots in
        ``dtype``. vlm: as dense; its prompt holds P patches and T tokens,
        so ``max_len`` must count P + T + the new tokens (a write past the
        end lands on slot S − 1, as in the reference). audio: an encoder,
        no decode — raises ValueError, as the reference does."""
        if not self.cfg.supports_decode:
            raise ValueError(f"{self.cfg.name} is encoder-only: no decode")
        dev = resolve_device(device)
        if self.cfg.family == "lstm":
            return {"lstm": lstm_init_state(self.cfg, batch, dtype, dev)}
        if max_len is None and self.cfg.family in ("dense", "moe", "vlm",
                                                   "hybrid"):
            raise ValueError(f"{self.cfg.name}: init_cache needs max_len")
        return stack_init_cache(self.cfg, batch, max_len or 0, dtype, dev)

    def prefill(self, params, batch, cache, resume: bool = False):
        """Forward over the prompt AND prime the decode cache.

        ``resume=True`` (LSTM only) continues from ``cache``'s recurrent
        state instead of zeros: the same cell sequence, so resumed prefill
        over a suffix equals one-shot prefill over the full prompt. Dense,
        SSM and hybrid caches are filled in place, the prompt at slots
        [0, T); their prefill does not resume, as in the reference. A vlm
        batch ``{"tokens", "patches"}`` fills slots [0, P + T), the text
        at M-RoPE positions max(gh, gw) + i (``decode_step`` then takes
        pos = P + T + j, the reference's convention). → (h (B, T, d),
        cache), T counting the patches for the vlm."""
        cfg = self.cfg
        if cfg.family == "lstm":
            x = embed_tokens(params["embed"], batch["tokens"])
            h, state = lstm_forward(params["lstm"], x, cfg,
                                    state=cache["lstm"] if resume else None)
            return h, {"lstm": state}
        if resume:
            raise NotImplementedError("resume prefill is LSTM-only, as in the "
                                      "reference")
        if cfg.family == "vlm":
            x, positions = self._vlm_input(params, batch)
        else:
            x, positions = embed_tokens(params["embed"], batch["tokens"]), None
        return stack_prefill(params["stack"], x, cfg, cache, positions)

    def decode_step(self, params, token, cache, pos=None):
        """token: (B,) int; ``pos``: the token's absolute position — an int,
        a 0-dim int32 tensor or a (B,) int32 tensor of per-row positions on
        the token's device (see ``layers/attention.py::attn_decode``); the
        LSTM and the SSM layers ignore it. Dense/SSM/hybrid caches are
        updated in place. → (h (B, d), cache)."""
        x1 = embed_tokens(params["embed"], token)
        if self.cfg.family == "lstm":
            h, new_state = lstm_decode_step(params["lstm"], x1, cache["lstm"],
                                            self.cfg)
            return h, {"lstm": new_state}
        h, cache = stack_decode(params["stack"], x1[:, None], cache, pos, self.cfg)
        return h[:, 0], cache

    def decode_step_paged(self, params, token, pool, page_table, pos):
        """Paged decode step (the dense and moe families): K/V live in a page pool
        ``{k, v (L, N_pages, P, KV, hd)}`` shared by every paged stream,
        addressed through ``page_table`` (B, n_pages) int32, instead of a
        contiguous cache; the pool is written in place. → (h (B, d),
        pool). See ``layers/transformer.py::stack_decode_paged``."""
        if self.cfg.family == "lstm":
            raise NotImplementedError(
                "LSTM decode carries no per-token KV: paged LSTM streams "
                "use the ordinary decode_step with logical page accounting")
        x1 = embed_tokens(params["embed"], token)
        h, pool = stack_decode_paged(params["stack"], x1[:, None], pool,
                                     page_table, pos, self.cfg)
        return h[:, 0], pool


def _sinusoidal(T: int, d: int, dtype, device=None) -> torch.Tensor:
    """(1, T, d) sinusoidal position table, computed in float32 and laid
    out [sin | cos] (not interleaved), as the reference's."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)[None]


def to_device(tree, device):
    """Every tensor of a nested dict/list moved to ``device``."""
    return tree_map(lambda a: a.to(device) if isinstance(a, torch.Tensor)
                    else a, tree)
