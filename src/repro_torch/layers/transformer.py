"""Layer stacks of the ``dense``, ``moe``, ``vlm``, ``audio``, ``ssm``
(mamba2) and ``hybrid`` (zamba2) families. Twin of
``repro/layers/transformer.py``.

  * dense: pre-norm attention + pre-norm MLP; the vlm (qwen2-vl-2b, M-RoPE
    over the caller's (B, T, 3) positions) and audio (hubert-xlarge,
    bidirectional: ``causal=not cfg.is_encoder``) stacks are this stack
  * moe: pre-norm attention + pre-norm MoE (``layers/moe.py``); a full
    sequence returns the aux loss summed over the layers
  * ssm (mamba2): pre-norm SSD block only
  * hybrid (zamba2): SSD layers with ONE weight-shared attention+MLP block
    applied after every ``hybrid_shared_period`` layers

Per-layer params keep the reference's stacked layout, a leading L axis on
every leaf of ``params["blocks"]``; Python loops over the layers replace
``lax.scan``. The decode caches are stacked the same way —
``{"attn": {k, v (L, B, S, KV, hd)}}`` for the dense, moe and vlm stacks (S =
the window for a sliding-window config: a ring buffer),
``{"ssm": {conv_tail (L, B, W-1, C), state (L, B, H, P, N)},
"shared_attn": {k, v (L / period, B, S, KV, hd)}}`` for the others — and
prefill and decode update them IN PLACE (the reference returns new caches).
``stack_decode_paged`` decodes the dense or moe stack against a page pool
``{k, v (L, N_pages, P, KV, hd)}`` instead, also in place.

A full-sequence pass reads the stacked params through ``unbind``, whose
backward stacks the layers' gradients once, rather than through one
``select`` a layer, whose backward writes a zero-filled copy of the whole
stacked leaf for every layer. ``remat=True`` checkpoints each dense or moe
layer, each Mamba2 layer and each super-block (the layers up to and
including a shared-block application), as the reference's
``jax.checkpoint`` around its scan bodies does; the stacks draw no random
numbers, so no RNG state is stashed for the recompute.

On a mesh the residual stream is pinned to the batch split
(``utils/shard.py::shard_batch``) at each layer's entry and exit, as the
reference pins it (its lines 109, 111 and 137), and each sublayer's
output, in every pass, to its residual stream's placement before the add
(``like``): where GSPMD all-reduces a row-parallel product's partial sums
(Megatron's schedule), DTensor would otherwise pick its own layout and
cascade it through the block. Each pin holds the gradient to the same
placement. Without a mesh they are no-ops.

``stack_forward`` and ``stack_prefill`` take the caller's ``positions``, as
the reference's do: (B, T) for RoPE (``arange(T)`` when None), (B, T, 3)
for M-RoPE (``rope.py::mrope_positions``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.attention import (attn_decode, attn_decode_paged,
                                          attn_forward_kv, attn_init)
from repro_torch.layers.attention import init_cache as attn_init_cache
from repro_torch.layers.initializers import init_device
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.moe import moe_apply, moe_init
from repro_torch.layers.norms import norm_apply, norm_init
from repro_torch.layers.ssm import (ssm_decode_step, ssm_forward, ssm_init,
                                    ssm_init_cache)
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.utils.shard import by_rows, like, shard_batch

ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")
SSM_FAMILIES = ("ssm", "hybrid")
STACK_FAMILIES = ATTN_FAMILIES + SSM_FAMILIES


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in STACK_FAMILIES:
        raise ValueError(f"{cfg.name}: no layer stack for the {cfg.family} "
                         f"family")


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
    """One layer's params for the cfg's family, or ``stack`` layers' along
    a leading axis."""
    _check_family(cfg)

    def norm():
        n = norm_init(cfg.d_model, cfg.norm, dtype, init_device(generator))
        if stack is not None:
            n = {k: v.expand(stack, -1).contiguous() for k, v in n.items()}
        return n
    if cfg.family in SSM_FAMILIES:
        return {"norm": norm(),
                "ssm": ssm_init(generator, cfg, dtype, stack=stack)}
    p = {"norm1": norm(), "attn": attn_init(generator, cfg, dtype, stack),
         "norm2": norm()}
    if cfg.family == "moe":
        p["moe"] = moe_init(generator, cfg, dtype, stack)
    else:
        p["mlp"] = mlp_init(generator, cfg, dtype, stack)
    return p


def shared_block_init(generator: torch.Generator, cfg: ModelConfig,
                      dtype=torch.float32):
    """Zamba2's single shared attention+MLP block."""
    dev = init_device(generator)
    return {"norm1": norm_init(cfg.d_model, cfg.norm, dtype, dev),
            "attn": attn_init(generator, cfg, dtype),
            "norm2": norm_init(cfg.d_model, cfg.norm, dtype, dev),
            "mlp": mlp_init(generator, cfg, dtype)}


def stack_init(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32):
    p = {"blocks": block_init(generator, cfg, dtype, stack=cfg.num_layers),
         "final_norm": norm_init(cfg.d_model, cfg.norm, dtype,
                                 init_device(generator))}
    if cfg.family == "hybrid":
        p["shared"] = shared_block_init(generator, cfg, dtype)
    return p


# -- full sequence --------------------------------------------------------------

def _positions(x: torch.Tensor, positions=None) -> torch.Tensor:
    """The caller's positions, or (B, T) ``arange(T)``."""
    if positions is not None:
        return positions
    T = x.shape[1]
    return by_rows(lambda B: torch.arange(T, dtype=torch.int32,
                                          device=x.device)[None].expand(B, T),
                   x)


def _shared_block(sp, x, cfg: ModelConfig, positions):
    """The shared attention+MLP block over a full sequence → (x, k, v)."""
    a_out, k, v = attn_forward_kv(sp["attn"], norm_apply(sp["norm1"], x, cfg.norm),
                                  cfg, positions, causal=True,
                                  window=cfg.sliding_window)
    h = x + like(a_out, x)
    return h + like(mlp_apply(sp["mlp"], norm_apply(sp["norm2"], h, cfg.norm),
                              cfg), h), k, v


def _ffn_residual(p, h, cfg: ModelConfig):
    """h + the layer's pre-norm MLP or MoE of h → (x, the MoE's aux loss,
    or None for an MLP)."""
    if cfg.family == "moe":
        y, aux = moe_apply(p["moe"], norm_apply(p["norm2"], h, cfg.norm), cfg)
        return h + like(y, h), aux
    return h + like(mlp_apply(p["mlp"], norm_apply(p["norm2"], h, cfg.norm),
                              cfg), h), None


def _dense_layer(p, x, cfg: ModelConfig, positions, cache=None):
    """One pre-norm attention + MLP (or MoE) layer over a full sequence →
    (x, aux or None); with ``cache`` (this layer's {k, v}) the prompt's K/V
    are written into slots [0, T) in place."""
    a_out, k, v = attn_forward_kv(p["attn"], norm_apply(p["norm1"], x, cfg.norm),
                                  cfg, positions, causal=not cfg.is_encoder,
                                  window=cfg.sliding_window)
    if cache is not None:
        S = cache["k"].shape[1]
        n = min(x.shape[1], S)
        cache["k"][:, :n].copy_(k[:, -S:])
        cache["v"][:, :n].copy_(v[:, -S:])
    return _ffn_residual(p, x + like(a_out, x), cfg)


def _check_ring_prompt(cfg: ModelConfig, T: int, cache) -> None:
    """A ring-buffer cache holds position p at slot p % S, and the prefill
    writes the prompt at slots [0, T): the prompt must fit the ring. The
    reference writes the last S positions at slots [0, S) and decodes on
    with them out of place (ROADMAP.md, Queue 3); the port refuses."""
    S = cache["attn"]["k"].shape[2]
    if cfg.sliding_window is not None and S == cfg.sliding_window and T > S:
        raise ValueError(f"{cfg.name}: a prompt of {T} tokens does not fit "
                         f"the {S}-slot ring-buffer cache of its window")


def _dense_stack_run(params, x, cfg: ModelConfig, cache=None, remat=False,
                     positions=None):
    """Prefill (``cache`` given: filled in place) or plain forward of the
    dense, moe, vlm or audio stack, with ``remat`` each layer checkpointed
    → (h, the aux loss summed over the layers: a float32 tensor for moe,
    else 0.0)."""
    positions = _positions(x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device) \
        if cfg.family == "moe" else 0.0
    for li, p in enumerate(_unstack(params["blocks"], cfg.num_layers)):
        # the reference's pins of the residual stream at the block
        # boundaries (no-ops without a mesh)
        x = shard_batch(x)
        if remat:
            x, a = checkpoint(_dense_layer, p, x, cfg, positions,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _dense_layer(p, x, cfg, positions, None if cache is None
                                else _layer(cache["attn"], li))
        x = shard_batch(x)
        if a is not None:
            aux = aux + a
    return norm_apply(params["final_norm"], x, cfg.norm), aux


def _ssm_layer(p, x, cfg: ModelConfig):
    """One pre-norm Mamba2 layer → (x + its output, its cache dict)."""
    y, c = ssm_forward(p["ssm"], norm_apply(p["norm"], x, cfg.norm), cfg)
    return x + like(y, x), c


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
            x = shard_batch(x)
            if remat:
                x = shard_batch(checkpoint(layer_out, layers[li], x,
                                           use_reentrant=False,
                                           preserve_rng_state=False))
                continue
            x, c = _ssm_layer(layers[li], x, cfg)
            x = shard_batch(x)
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


def stack_forward(params, x, cfg: ModelConfig, positions=None,
                  remat: bool = False):
    """Full-sequence stack. x: (B, T, d); ``positions`` (B, T) or, for
    M-RoPE, (B, T, 3) (``arange(T)`` when None; the SSM stacks' shared
    block uses ``arange(T)``, as the reference's) → (h (B, T, d), aux loss:
    the moe layers' sum, a float32 tensor; 0.0 for the others).
    ``remat=True`` checkpoints each layer (and each super-block of the SSM
    stacks): the backward recomputes them instead of keeping their
    activations."""
    _check_family(cfg)
    if cfg.family in ATTN_FAMILIES:
        return _dense_stack_run(params, x, cfg, remat=remat,
                                positions=positions)
    return _ssm_stack_run(params, x, cfg, remat=remat), 0.0


def stack_prefill(params, x, cfg: ModelConfig, cache, positions=None):
    """Forward pass that also fills the decode cache, in place: the
    prompt's K/V (slots [0, T)), and the SSM stacks' final states and conv
    tails. x: (B, T, d), ``positions`` as ``stack_forward``'s → (h, cache).
    The prompt occupies slots [0, T), as in the reference's non-resumable
    prefill; a ring-buffer cache must hold the whole prompt
    (``_check_ring_prompt``). A plain cache shorter than T keeps the
    prompt's last S positions, as the reference's does."""
    _check_family(cfg)
    if cfg.family in ATTN_FAMILIES:
        _check_ring_prompt(cfg, x.shape[1], cache)
        return _dense_stack_run(params, x, cfg, cache,
                                positions=positions)[0], cache
    return _ssm_stack_run(params, x, cfg, cache), cache


# -- caches & decode ------------------------------------------------------------

def stack_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.float32, device=None):
    """Stacked per-layer caches (leading L axis) + shared-block caches:
    the dense, moe and vlm stacks' K/V caches of ``max_len`` slots (a ring of
    ``sliding_window`` slots for a windowed config), or the SSM stacks'.
    Only the K/V caches take ``dtype``: conv tails and SSM states are
    float32, because the reference's prefill and decode replace its
    ``dtype`` conv tails with the float32 tails they compute, and this
    cache is written in place."""
    _check_family(cfg)
    if cfg.family in ATTN_FAMILIES:
        return {"attn": attn_init_cache(cfg, batch, max_len, dtype,
                                        window=cfg.sliding_window,
                                        device=device, stack=cfg.num_layers)}
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
    int32 tensor, see ``attn_decode``) reaches the attention layers; the
    Mamba2 layers ignore it."""
    _check_family(cfg)
    if cfg.family in ATTN_FAMILIES:
        for li in range(cfg.num_layers):
            p = _layer(params["blocks"], li)
            a_out, _ = attn_decode(p["attn"],
                                   norm_apply(p["norm1"], x1, cfg.norm),
                                   _layer(cache["attn"], li), pos, cfg,
                                   window=cfg.sliding_window)
            x1 = _ffn_residual(p, x1 + like(a_out, x1), cfg)[0]
        return norm_apply(params["final_norm"], x1, cfg.norm), cache
    period = _period(cfg)
    for i in range(cfg.num_layers // period):
        for j in range(period):
            li = i * period + j
            p = _layer(params["blocks"], li)
            c = _layer(cache["ssm"], li)
            y, new_c = ssm_decode_step(p["ssm"], norm_apply(p["norm"], x1, cfg.norm),
                                       c, cfg)
            x1 = x1 + like(y, x1)
            _copy_into(c, new_c)
        if cfg.family == "hybrid":
            sp = params["shared"]
            a_out, _ = attn_decode(sp["attn"], norm_apply(sp["norm1"], x1, cfg.norm),
                                   _layer(cache["shared_attn"], i), pos, cfg,
                                   window=cfg.sliding_window)
            h = x1 + like(a_out, x1)
            x1 = h + like(mlp_apply(sp["mlp"],
                                    norm_apply(sp["norm2"], h, cfg.norm), cfg),
                          h)
    return norm_apply(params["final_norm"], x1, cfg.norm), cache



def stack_decode_paged(params, x1, pool, page_table, pos, cfg: ModelConfig):
    """One-token decode through the dense or moe stack against block-paged
    KV storage. ``pool``: {"k", "v"} (L, N_pages, P, KV, hd), written in
    place; ``page_table``: (B, n_pages) int32 shared by every layer (layer
    l of sequence page j lives at pool[l, page_table[:, j]]). → (h (B, 1,
    d), pool). The same block body and op order as ``stack_decode``, with
    ``attn_decode_paged`` in place of the cache write, which keeps paged
    greedy tokens bit-identical to the contiguous path."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: paged decode takes the dense and moe stacks, not "
            f"{cfg.family}")
    for li in range(cfg.num_layers):
        p = _layer(params["blocks"], li)
        a_out, _, _ = attn_decode_paged(
            p["attn"], norm_apply(p["norm1"], x1, cfg.norm), pool["k"][li],
            pool["v"][li], page_table, pos, cfg)
        x1 = _ffn_residual(p, x1 + like(a_out, x1), cfg)[0]
    return norm_apply(params["final_norm"], x1, cfg.norm), pool
