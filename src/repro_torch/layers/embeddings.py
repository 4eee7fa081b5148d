"""Token embedding + LM head (optionally tied). Twin of
``repro/layers/embeddings.py``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.attention import matmul
from repro_torch.layers.initializers import dense_init, init_device
from repro_torch.utils.shard import lookup, split_as


def embed_init(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32):
    p = {"embedding": dense_init(generator, (cfg.vocab_size, cfg.d_model),
                                 dtype, scale=0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, (cfg.vocab_size, cfg.d_model),
                                  dtype, scale=0.02)
    p["lm_bias"] = torch.zeros((cfg.vocab_size,), dtype=dtype,
                              device=init_device(generator))
    return p


def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    """On a mesh, a vocab-parallel lookup (``utils/shard.py::lookup``)."""
    return lookup(params["embedding"], tokens.long())


def head_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    """The softmax weight matrix W (vocab, d) the paper screens."""
    return params["embedding"] if cfg.tie_embeddings else params["lm_head"]


def lm_logits(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full (unscreened) softmax logits: x = W·h + b. h: (..., d); float32
    h against bf16 weights (hubert-xlarge's bf16 config) gives float32.
    On a mesh the logits are pinned to the batch split and W's vocab
    split: DTensor would otherwise sum them over W's FSDP-split d and
    gather the whole vocabulary, where GSPMD gathers W's d instead."""
    W = head_matrix(params, cfg)
    return split_as(matmul(h, W.T), h.dim() - 1, W, 0) + params["lm_bias"]
