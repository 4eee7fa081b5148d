"""Attention: MHA / GQA / MQA with RoPE, causal or bidirectional masks, and
one-token KV-cache decode. Twin of ``repro/layers/attention.py``.

Conventions:
  x                (B, T, d_model)
  q                (B, T, H, hd)      grouped as (B, T, KV, Q_PER_KV, hd)
  k, v             (B, S, KV, hd)
  cache            dict(k, v)         k/v (B, S_max, KV, hd); RoPE applied at
                                      write time (absolute positions).

The projections and ``_sdpa`` are plain PyTorch (the JAX package has no
attention kernel). The decode step's K and V cache writes go through
``kernels/cache_update.py::cache_kv_update`` — one launch of the CUDA kernel
on the card.

Not ported yet (each raises NotImplementedError, ROADMAP.md Queue 1): the
vector-``pos`` decode branch, ring-buffer (sliding-window) caches, the
chunked attention path for T ≥ 2048, M-RoPE and ``attn_decode_paged``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.cache_update import cache_kv_update
from repro_torch.layers.initializers import dense_init
from repro_torch.layers.rope import apply_rope

NEG_INF = -1e30
# Above this many query positions the reference switches to its chunked
# attention path (``_sdpa_chunked``), which is not ported yet.
CHUNKED_ATTN_THRESHOLD = 2048


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, Queue 1)")


def attn_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": dense_init(generator, (d, h, hd), dtype),
         "wk": dense_init(generator, (d, kv, hd), dtype),
         "wv": dense_init(generator, (d, kv, hd), dtype),
         "wo": dense_init(generator, (h, hd, d), dtype)}
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
    return p


def _proj(x, w):
    """x (B, T, d) · w (d, n, hd) → (B, T, n, hd), one matmul."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).reshape(*x.shape[:-1], n, hd)


def _project_qkv(params, x, cfg: ModelConfig, positions):
    """positions: (B, T) int for rope | None."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    if cfg.positional == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.positional == "mrope":
        raise _not_ported("M-RoPE")
    return q, k, v


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q (B,T,H,hd), k/v (B,S,KV,hd), mask (B,T,S) or (T,S) bool (True=keep).
    Scores and the weighted sum accumulate in float32."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, T, KV, g, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def make_mask(T: int, S: int, causal: bool, window: Optional[int] = None,
              device=None) -> torch.Tensor:
    """(T, S) bool keep-mask, query row i at absolute position i."""
    qpos = torch.arange(T, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    m = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def attn_forward(params, x, cfg: ModelConfig, positions, causal: bool = True,
                 window: Optional[int] = None):
    """Full-sequence attention (training / prefill). Returns (B, T, d)."""
    return attn_forward_kv(params, x, cfg, positions, causal, window)[0]


def attn_forward_kv(params, x, cfg: ModelConfig, positions,
                    causal: bool = True, window: Optional[int] = None):
    """Like attn_forward but also returns (k, v) for cache priming."""
    q, k, v = _project_qkv(params, x, cfg, positions)
    T = x.shape[1]
    w = window if window is not None else cfg.sliding_window
    if T >= CHUNKED_ATTN_THRESHOLD:
        raise _not_ported(f"chunked attention (_sdpa_chunked, T = {T} ≥ "
                          f"{CHUNKED_ATTN_THRESHOLD})")
    mask = make_mask(T, T, causal=causal, window=w, device=x.device)
    out = _sdpa(q, k, v, mask, cfg)
    return _proj_out(out, params["wo"]), k, v


def _proj_out(out, wo):
    """out (B, T, H, hd) · wo (H, hd, d) → (B, T, d)."""
    H, hd, d = wo.shape
    return out.reshape(*out.shape[:2], H * hd) @ wo.reshape(H * hd, d)


# -- KV-cache decode ---------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
               window: Optional[int] = None, device=None,
               stack: Optional[int] = None):
    """Standard cache of ``max_len`` slots: k/v (B, S, KV, hd), or ``stack``
    of them along a leading axis. Ring buffers are not ported yet."""
    if window is not None:
        raise _not_ported("the ring-buffer (sliding-window) cache")
    lead = () if stack is None else (stack,)
    shape = lead + (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(params, x1, cache, pos, cfg: ModelConfig,
                window: Optional[int] = None):
    """One-token decode. x1: (B, 1, d); pos: scalar int absolute position.

    Writes this token's K/V at slot ``pos`` of every row through
    ``cache_kv_update`` — IN PLACE: ``cache`` itself is updated, where the
    reference returns a new cache and leaves its argument as it was. A
    caller that needs the old cache must copy it first. A slot past the end
    is clamped to S − 1, as the reference's ``dynamic_update_slice`` does.

    Returns (out (B, 1, d), cache). The vector-``pos`` branch (per-row
    positions) and ring buffers raise NotImplementedError."""
    if isinstance(pos, torch.Tensor) and pos.dim() > 0:
        raise _not_ported("vector-pos attention decode")
    pos = int(pos)
    w = window if window is not None else cfg.sliding_window
    S = cache["k"].shape[1]
    if w is not None and S == w:
        raise _not_ported("ring-buffer attention decode")
    B = x1.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x1.device)
    q, k, v = _project_qkv(params, x1, cfg, positions)
    dtype = cache["k"].dtype
    ck, cv = cache_kv_update(cache["k"], k[:, 0].to(dtype).contiguous(),
                             cache["v"], v[:, 0].to(dtype).contiguous(), pos)
    valid = torch.arange(S, device=x1.device) <= pos
    mask = valid[None, None, :].expand(B, 1, S)
    out = _sdpa(q, ck, cv, mask, cfg)
    return _proj_out(out, params["wo"]), {"k": ck, "v": cv}


def attn_decode_paged(*args, **kwargs):
    """One-token decode against block-paged KV storage: not ported yet."""
    raise _not_ported("attn_decode_paged (paged KV decode)")
