"""Layer stacks of the ``ssm`` (mamba2) and ``hybrid`` (zamba2) families.
Twin of ``repro/layers/transformer.py``'s SSM branches.

  * ssm (mamba2): pre-norm SSD block only
  * hybrid (zamba2): SSD layers with ONE weight-shared attention+MLP block
    applied after every ``hybrid_shared_period`` layers

Per-layer params keep the reference's stacked layout, a leading L axis on
every leaf of ``params["blocks"]``; Python loops over the layers replace
``lax.scan``. The decode caches are stacked the same way —
``{"ssm": {conv_tail (L, B, W-1, C), state (L, B, H, P, N)},
"shared_attn": {k, v (L / period, B, S, KV, hd)}}`` — and prefill and decode
update them IN PLACE (the reference returns new caches).

A full-sequence pass reads the stacked params through ``unbind``, whose
backward stacks the layers' gradients once, rather than through one
``select`` a layer, whose backward writes a zero-filled copy of the whole
stacked leaf for every layer. ``remat=True`` checkpoints each Mamba2 layer
and each super-block (the layers up to and including a shared-block
application), as the reference's ``jax.checkpoint`` around ``inner`` and
``super_body`` does; the stacks draw no random numbers, so no RNG state is
stashed for the recompute.

The dense / moe / vlm / audio stacks are not ported yet (ROADMAP.md,
Queue 1).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.attention import (attn_decode, attn_forward_kv,
                                          attn_init)
from repro_torch.layers.attention import init_cache as attn_init_cache
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.norms import norm_apply, norm_init
from repro_torch.layers.ssm import (ssm_decode_step, ssm_forward, ssm_init,
                                    ssm_init_cache)
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

SSM_FAMILIES = ("ssm", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in SSM_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} stack is not ported yet (repro_torch "
            f"ports the lstm, ssm and hybrid families; ROADMAP.md, Queue 1)")


def _period(cfg: ModelConfig) -> int:
    period = cfg.hybrid_shared_period if cfg.family == "hybrid" else cfg.num_layers
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a "
                         f"multiple of the shared period {period}")
    return period


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree: a view of every leaf at index i."""
    return tree_map(lambda a: a[i], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, each a tree of ``unbind`` views."""
    per_leaf = [a.unbind(0) for a in tree_flatten(tree)]
    return [tree_unflatten(tree, [u[i] for u in per_leaf]) for i in range(n)]


def _copy_into(dst, src) -> None:
    """Write every leaf of ``src`` into the same leaf of ``dst``, in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


# -- init ---------------------------------------------------------------------

def block_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               stack: Optional[int] = None) -> Dict[str, Any]:
    """One SSM layer's params, or ``stack`` layers' along a leading axis."""
    _check_family(cfg)
    norm = norm_init(cfg.d_model, cfg.norm, dtype, generator.device)
    if stack is not None:
        norm = {k: v.expand(stack, -1).contiguous() for k, v in norm.items()}
    return {"norm": norm, "ssm": ssm_init(generator, cfg, dtype, stack=stack)}


def shared_block_init(generator: torch.Generator, cfg: ModelConfig,
                      dtype=torch.float32):
    """Zamba2's single shared attention+MLP block."""
    dev = generator.device
    return {"norm1": norm_init(cfg.d_model, cfg.norm, dtype, dev),
            "attn": attn_init(generator, cfg, dtype),
            "norm2": norm_init(cfg.d_model, cfg.norm, dtype, dev),
            "mlp": mlp_init(generator, cfg, dtype)}


def stack_init(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32):
    p = {"blocks": block_init(generator, cfg, dtype, stack=cfg.num_layers),
         "final_norm": norm_init(cfg.d_model, cfg.norm, dtype,
                                 generator.device)}
    if cfg.family == "hybrid":
        p["shared"] = shared_block_init(generator, cfg, dtype)
    return p


# -- full sequence --------------------------------------------------------------

def _positions(x: torch.Tensor) -> torch.Tensor:
    B, T = x.shape[:2]
    return torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)


def _shared_block(sp, x, cfg: ModelConfig, positions):
    """The shared attention+MLP block over a full sequence → (x, k, v)."""
    a_out, k, v = attn_forward_kv(sp["attn"], norm_apply(sp["norm1"], x, cfg.norm),
                                  cfg, positions, causal=True,
                                  window=cfg.sliding_window)
    h = x + a_out
    return h + mlp_apply(sp["mlp"], norm_apply(sp["norm2"], h, cfg.norm), cfg), k, v


def _ssm_layer(p, x, cfg: ModelConfig):
    """One pre-norm Mamba2 layer → (x + its output, its cache dict)."""
    y, c = ssm_forward(p["ssm"], norm_apply(p["norm"], x, cfg.norm), cfg)
    return x + y, c


def _ssm_stack_run(params, x, cfg: ModelConfig, cache=None, remat=False):
    """Prefill (``cache`` given: filled in place) or plain forward, with
    ``remat`` each layer and each super-block checkpointed."""
    _check_family(cfg)
    period = _period(cfg)
    positions = _positions(x)
    layers = _unstack(params["blocks"], cfg.num_layers)

    def layer_out(p, h):
        return _ssm_layer(p, h, cfg)[0]

    def super_block(x, i):
        for j in range(period):
            li = i * period + j
            if remat:
                x = checkpoint(layer_out, layers[li], x, use_reentrant=False,
                               preserve_rng_state=False)
                continue
            x, c = _ssm_layer(layers[li], x, cfg)
            if cache is not None:
                _copy_into(_layer(cache["ssm"], li), c)
        if cfg.family == "hybrid":
            x, k, v = _shared_block(params["shared"], x, cfg, positions)
            if cache is not None:
                attn_c = _layer(cache["shared_attn"], i)
                S = attn_c["k"].shape[1]
                n = min(x.shape[1], S)
                attn_c["k"][:, :n].copy_(k[:, -S:])
                attn_c["v"][:, :n].copy_(v[:, -S:])
        return x

    for i in range(cfg.num_layers // period):
        x = (checkpoint(super_block, x, i, use_reentrant=False,
                        preserve_rng_state=False) if remat
             else super_block(x, i))
    return norm_apply(params["final_norm"], x, cfg.norm)


def stack_forward(params, x, cfg: ModelConfig, remat: bool = False):
    """Full-sequence stack. x: (B, T, d) → (h (B, T, d), aux loss 0.0).
    ``remat=True`` checkpoints each layer and each super-block: the
    backward recomputes them instead of keeping their activations."""
    return _ssm_stack_run(params, x, cfg, remat=remat), 0.0


def stack_prefill(params, x, cfg: ModelConfig, cache):
    """Forward pass that also fills the decode cache with the final SSM
    states and conv tails and the prompt's K/V (slots [0, T)), in place.
    x: (B, T, d) → (h, cache)."""
    return _ssm_stack_run(params, x, cfg, cache), cache


# -- caches & decode ------------------------------------------------------------

def stack_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.float32, device=None):
    """Stacked per-layer caches (leading L axis) + shared-block caches.
    Only the K/V caches take ``dtype``: conv tails and SSM states are
    float32, because the reference's prefill and decode replace its
    ``dtype`` conv tails with the float32 tails they compute, and this
    cache is written in place."""
    _check_family(cfg)
    cache = {"ssm": ssm_init_cache(cfg, batch, torch.float32, device,
                                   stack=cfg.num_layers)}
    if cfg.family == "hybrid":
        cache["shared_attn"] = attn_init_cache(
            cfg, batch, max_len, dtype, window=cfg.sliding_window,
            device=device, stack=cfg.num_layers // _period(cfg))
    return cache


def stack_decode(params, x1, cache, pos, cfg: ModelConfig):
    """One-token decode through the stack. x1: (B, 1, d) → (h (B, 1, d),
    cache), the cache updated in place. ``pos`` (an int, a 0-dim or a (B,)
    int32 tensor, see ``attn_decode``) reaches the shared attention block;
    the Mamba2 layers ignore it."""
    _check_family(cfg)
    period = _period(cfg)
    for i in range(cfg.num_layers // period):
        for j in range(period):
            li = i * period + j
            p = _layer(params["blocks"], li)
            c = _layer(cache["ssm"], li)
            y, new_c = ssm_decode_step(p["ssm"], norm_apply(p["norm"], x1, cfg.norm),
                                       c, cfg)
            x1 = x1 + y
            _copy_into(c, new_c)
        if cfg.family == "hybrid":
            sp = params["shared"]
            a_out, _ = attn_decode(sp["attn"], norm_apply(sp["norm1"], x1, cfg.norm),
                                   _layer(cache["shared_attn"], i), pos, cfg,
                                   window=cfg.sliding_window)
            h = x1 + a_out
            x1 = h + mlp_apply(sp["mlp"], norm_apply(sp["norm2"], h, cfg.norm), cfg)
    return norm_apply(params["final_norm"], x1, cfg.norm), cache

