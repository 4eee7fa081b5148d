"""Attention: MHA / GQA / MQA with RoPE or M-RoPE, causal or bidirectional
masks, and one-token KV-cache decode. Twin of ``repro/layers/attention.py``.

Conventions:
  x                (B, T, d_model)
  q                (B, T, H, hd)      grouped as (B, T, KV, Q_PER_KV, hd)
  k, v             (B, S, KV, hd)
  cache            dict(k, v)         k/v (B, S_max, KV, hd); RoPE applied at
                                      write time (absolute positions).

The projections, ``_sdpa`` and ``_sdpa_chunked`` (the full-sequence path
for T ≥ ``CHUNKED_ATTN_THRESHOLD``) are plain PyTorch: the JAX package has no
attention kernel and leaves them to XLA. Their products accumulate in
float32 from the storage dtype, as the reference's
``preferred_element_type=float32`` einsums do. The decode step's K and V
cache writes go through ``kernels/cache_update.py::cache_kv_update`` — one
launch of the CUDA kernel on the card. ``attn_decode_paged`` writes its
token into a page pool with a plain indexed write, as the reference does
with an XLA scatter (no Pallas kernel).

A sliding-window config decodes through a ring-buffer cache of ``window``
slots (``init_cache(window=w)``): position p lives in slot p % w.

A product of two dtypes (float32 activations against bfloat16 weights, as
hubert-xlarge's float32 frames give in its bf16 config) is taken in the
wider dtype, the weights widened exactly, as JAX's einsum promotes them.

On a mesh (DTensors, ``launch/dryrun.py``) the projections' heads are
pinned to split as their weights' (``_proj``, ``_proj_out``); attention
splits the query heads where the KV grouping allows (``_grouped``,
``_per_kv_group``), else its query rows over "model" in the chunked path
(``_sdpa_chunked``'s sequence-parallel branch), else runs replicated over
"model". Without a mesh none of this changes an op.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.cache_update import cache_kv_update
from repro_torch.layers.initializers import dense_init, init_device
from repro_torch.layers.rope import apply_mrope, apply_rope
from repro_torch.utils.shard import (batch_placements, is_dtensor,
                                     model_axis_size, per_device,
                                     shard_axis, shard_batch,
                                     shard_offset_of, split_as)

NEG_INF = -1e30
# Above this many query positions, full-sequence attention switches to the
# chunked path, so the (T, S) score matrix never exists whole.
CHUNKED_ATTN_THRESHOLD = 2048
Q_CHUNK = 512


def attn_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
              stack: Optional[int] = None):
    """One layer's projections, or ``stack`` layers' along a leading axis."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": dense_init(generator, (d, h, hd), dtype, stack=stack),
         "wk": dense_init(generator, (d, kv, hd), dtype, stack=stack),
         "wv": dense_init(generator, (d, kv, hd), dtype, stack=stack),
         "wo": dense_init(generator, (h, hd, d), dtype, stack=stack)}
    if cfg.qkv_bias:
        lead = () if stack is None else (stack,)
        dev = init_device(generator)
        p["bq"] = torch.zeros(lead + (h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(lead + (kv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(lead + (kv, hd), dtype=dtype, device=dev)
    return p


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the wider of their dtypes (JAX's einsum promotion: float32
    activations against bfloat16 weights give float32)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def _proj(x, w):
    """x (B, T, d) · w (d, n, hd) → (B, T, n, hd), one matmul. On a mesh
    the product's columns are pinned to split as w's heads split (or not
    at all): DTensor would otherwise split them wherever it is cheapest,
    across heads that do not divide, and the reshape could not follow."""
    d, n, hd = w.shape
    y = split_as(matmul(x, w.reshape(d, n * hd)), x.dim() - 1, w, 1)
    return split_as(y.reshape(*x.shape[:-1], n, hd), x.dim() - 1, w, 1)


def _project_qkv(params, x, cfg: ModelConfig, positions):
    """positions: (B, T) int for rope | (B, T, 3) for mrope | unused for
    ``learned`` (hubert-xlarge: its sinusoids are added to the input, no
    rotation here, as in the reference)."""
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
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q (B,T,H,hd), k/v (B,S,KV,hd), mask (B,T,S) or (T,S) bool (True=keep).
    Scores and the weighted sum accumulate in float32, from k cast to q's
    dtype and the probabilities cast to v's, the reference's rounding
    points. The operands are widened to float32 first (exactly), so a
    bfloat16 cache of S slots is copied to float32 for each call: the
    reference's bf16 einsums with float32 accumulation avoid that copy."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = _grouped(q, KV).reshape(B, T, KV, g, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(),
                          k.to(q.dtype).float())
    scores = scores / math.sqrt(hd)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype).float(),
                       v.float())
    return _grouped(out.reshape(B, T, H, hd).to(q.dtype), KV)


def _sdpa_chunked(q, k, v, cfg: ModelConfig, causal: bool,
                  window: Optional[int], q_chunk: int = Q_CHUNK):
    """Memory-bounded attention, a loop over query chunks of ``q_chunk``
    (the tail padded): one (B, KV, g, q_chunk, S) score tile at a time,
    causal and window masks at absolute positions, softmax over the whole
    key axis in each chunk (no online-softmax carry). K and V are cast to
    q's dtype first and the products accumulate in float32, as in the
    reference's ``_sdpa_chunked``.

    SEQUENCE-PARALLEL path, the reference's: on a mesh whose ``model``
    axis the head count does not divide (smollm 15 heads, gemma 8,
    starcoder2 24, qwen2-vl 12 on 16), the heads cannot split, so each
    chunk's QUERY rows are split over ``model`` instead
    (``utils/shard.py::shard_axis``): every device scores q_chunk / m rows
    against the whole K/V, and the score tiles, FLOPs and bytes divide by
    m. Without a mesh it changes nothing."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    g = H // KV
    pad = (-T) % q_chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    nq = (T + pad) // q_chunk
    qc = _grouped(q, KV).reshape(B, nq, q_chunk, KV, g, hd).float()
    kf = k.to(q.dtype).float()
    vf = v.to(q.dtype)
    vff = vf.float()
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    kpos = torch.arange(S, device=q.device)
    msize = model_axis_size()
    split = msize > 1 and H % msize != 0 and q_chunk % msize == 0
    outs = []
    for i in range(nq):
        qpos = i * q_chunk + torch.arange(q_chunk, device=q.device)
        qi = shard_axis(qc[:, i], 1, "model") if split else qc[:, i]
        scores = torch.einsum("bqkgh,bskh->bkgqs", qi, kf) * scale
        m = torch.ones((q_chunk, S), dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            m &= kpos[None, :] > qpos[:, None] - window
        scores = torch.where(m, scores, NEG_INF)
        if split:
            scores = shard_axis(scores, 3, "model")
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(vf.dtype).float(),
                           vff)
        # the query rows gathered again (the reference's re-gather)
        outs.append(shard_batch(out) if split else out)
    out = torch.stack(outs, dim=1).reshape(B, T + pad, H, hd)
    return _grouped(out[:, :T].to(q.dtype), KV)


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
    is_causal = causal and not cfg.is_encoder
    if T >= CHUNKED_ATTN_THRESHOLD:
        out = _per_kv_group(lambda q, k, v: _sdpa_chunked(
            q, k, v, cfg, is_causal, w), q, k, v)
    else:
        mask = make_mask(T, T, causal=is_causal, window=w, device=x.device)
        out = _per_kv_group(lambda q, k, v: _sdpa(q, k, v, mask, cfg),
                            q, k, v)
    return _proj_out(out, params["wo"]), k, v


def _per_kv_group(fn, q, k, v):
    """``fn(q, k, v)`` (full-sequence attention), and on a mesh whose
    "model" axis splits the query heads but not the KV heads, and each
    device's heads fall in one KV head's group (phi3.5 and mixtral: 32
    heads, 8 KV, on 16), per device: its query heads against its KV head,
    whose gradient is a partial sum over "model" (GSPMD splits the
    grouped heads so too). Elsewhere ``_grouped`` gathers the heads."""
    m = model_axis_size()
    H, KV = q.shape[2], k.shape[2]
    if not (is_dtensor(q) and m > 1 and H % m == 0 and KV > 1 and KV % m
            and m % KV == 0):
        return fn(q, k, v)
    from torch.distributed.tensor import Shard
    mesh = q.device_mesh
    mi = mesh.mesh_dim_names.index("model")
    bp = batch_placements(q, mesh)
    heads = tuple(Shard(2) if i == mi else p for i, p in enumerate(bp))
    kv = shard_offset_of(mesh, heads, 2, H) // (H // KV)

    def local(ql, kl, vl):
        return fn(ql, kl[:, :, kv:kv + 1], vl[:, :, kv:kv + 1])
    return per_device(local, (q, k, v), (heads, bp, bp), (heads,), mesh=mesh)


def _proj_out(out, wo):
    """out (B, T, H, hd) · wo (H, hd, d) → (B, T, d). On a mesh the heads
    are pinned to split as wo's, on both sides of the reshape (value and
    gradient), as in ``_proj``."""
    H, hd, d = wo.shape
    flat = split_as(split_as(out, 2, wo, 0).reshape(*out.shape[:2], H * hd),
                    2, wo, 0)
    return matmul(flat, wo.reshape(H * hd, d))


def _grouped(q, KV: int):
    """q (B, T, H, hd), ready to be viewed as (B, T, KV, H / KV, hd): on a
    mesh whose "model" axis splits the heads but not the KV heads (phi3.5
    and mixtral: 32 heads, 8 KV, on 16), the heads are gathered (DTensor
    cannot split one dim across the two the view makes; GSPMD can), and
    attention runs replicated over "model". One KV head (gemma's MQA)
    leaves the split on the query heads. Applied to attention's output as
    well, so that its gradient comes back gathered too."""
    if KV > 1 and KV % model_axis_size():
        return split_as(q, 2, None, 0)
    return q


# -- KV-cache decode ---------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
               window: Optional[int] = None, device=None,
               stack: Optional[int] = None):
    """Standard cache of ``max_len`` slots, or a ring buffer of ``window``
    slots: k/v (B, S, KV, hd), or ``stack`` of them along a leading axis."""
    S = window if window is not None else max_len
    lead = () if stack is None else (stack,)
    shape = lead + (batch, S, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(params, x1, cache, pos, cfg: ModelConfig,
                window: Optional[int] = None):
    """One-token decode. x1: (B, 1, d); pos: the token's absolute position
    — a Python int, a 0-dim int32 tensor on x1's device (one position for
    every row), or a (B,) int32 tensor of per-row positions. An M-RoPE
    config (qwen2-vl-2b) rotates by ``pos`` in all three components, as the
    reference does: its prompt's text positions count from max(gh, gw), its
    cache slots from 0, and the caller decodes at pos == slot, so the
    position jumps after the prompt (16 + T - 1 to P + T at P = 256).

    Writes this token's K/V at slot ``pos`` of every row through
    ``cache_kv_update`` — IN PLACE: ``cache`` itself is updated, where the
    reference returns a new cache and leaves its argument as it was. A
    caller that needs the old cache must copy it first. A slot past the end
    is clamped to S − 1, as the reference's ``dynamic_update_slice`` does.

    Ring buffer: when ``window`` (or ``cfg.sliding_window``) is set and the
    cache holds exactly that many slots, the token goes to slot pos % S and
    the keep-mask is ``arange(S) < min(pos + 1, S)``: once the ring has
    wrapped it holds the last S positions, the window.

    A tensor ``pos`` is never read on the host: the RoPE positions, the
    keep-mask and the per-row cache slots (wrapped on the device for a
    ring) are built from it on the device, so a CUDA graph that captures
    this step reads the position each replay finds in the tensor. For rows
    at equal positions the tensor and int paths give bit-identical outputs
    and caches.

    Returns (out (B, 1, d), cache)."""
    w = window if window is not None else cfg.sliding_window
    S = cache["k"].shape[1]
    ring = w is not None and S == w
    B = x1.shape[0]
    if isinstance(pos, torch.Tensor):
        if pos.dim() > 1 or (pos.dim() == 1 and pos.shape[0] != B):
            raise ValueError(f"pos must be 0-dim or ({B},), got "
                             f"{tuple(pos.shape)}")
        pvec = pos.to(torch.int32).expand(B).contiguous()
        slot = torch.remainder(pvec, S) if ring else pvec
    else:
        slot = int(pos) % S if ring else int(pos)
        pvec = torch.full((B,), int(pos), dtype=torch.int32, device=x1.device)
    if cfg.positional == "mrope":
        # a decoded token's three components are equal (its text position)
        q, k, v = _project_qkv(params, x1, cfg, pvec[:, None, None].expand(
            B, 1, 3))
    else:
        q, k, v = _project_qkv(params, x1, cfg, pvec[:, None])
    dtype = cache["k"].dtype
    ck, cv = cache_kv_update(cache["k"], k[:, 0].to(dtype).contiguous(),
                             cache["v"], v[:, 0].to(dtype).contiguous(), slot)
    arange = torch.arange(S, device=x1.device)[None, :]
    if ring:
        valid = arange < torch.clamp(pvec + 1, max=S)[:, None]
    else:
        valid = arange <= pvec[:, None]
    out = _sdpa(q, ck, cv, valid[:, None, :], cfg)
    return _proj_out(out, params["wo"]), {"k": ck, "v": cv}


def attn_decode_paged(params, x1, pk, pv, page_table, pos, cfg: ModelConfig):
    """One-token decode against block-paged KV storage (one layer's pool).

    pk/pv: (N_pages, P, KV, hd) page pool, written IN PLACE; page_table:
    (B, n_pages) int32 mapping each row's sequence pages to pool pages;
    pos: a (B,) int32 tensor of per-row positions (or an int / 0-dim
    tensor for every row). Returns (out (B, 1, d), pk, pv).

    Each row writes its new K/V at (page_table[row, min(pos // P,
    n_pages − 1)], pos % P) — a plain indexed write, the reference's XLA
    scatter — and attends over the gathered view pk[page_table] reshaped to
    a dense (B, n_pages·P, KV, hd): the contiguous cache's exact shape when
    n_pages·P == max_len, with identical values at every position <= pos
    and the identical ``arange(S) <= pos`` keep-mask. So paged decode gives
    ``attn_decode``'s tensor-pos outputs bit for bit: masked scores are
    NEG_INF exactly, their probabilities exp to exact 0.0, and 0.0 times a
    finite stale row adds exact zeros.

    Stale rows: a freed page keeps its last occupant's rows until someone
    writes it, and page 0 (the trash page) takes every idle row's parked
    write at (0, 0) (rows writing one place at once leave one of their
    values there). Neither can leak: positions beyond a row's ``pos`` are
    masked, a join writes every row of its prompt pages before they become
    visible, and idle rows' outputs are discarded. This rests only on stale
    contents staying FINITE; nothing writes inf or NaN into a page."""
    B = x1.shape[0]
    if isinstance(pos, torch.Tensor):
        pvec = pos.to(torch.int32).expand(B)
    else:
        pvec = torch.full((B,), int(pos), dtype=torch.int32, device=x1.device)
    q, k, v = _project_qkv(params, x1, cfg, pvec[:, None])
    P = pk.shape[1]
    n_pages = page_table.shape[1]
    S = n_pages * P
    rows = torch.arange(B, device=x1.device)
    # clamp like the contiguous path's write past the end: an idle slot
    # parked at 0 lands on the trash page its table row points at anyway
    page = page_table[rows, torch.clamp(pvec // P, max=n_pages - 1)].long()
    off = (pvec % P).long()
    pk[page, off] = k[:, 0].to(pk.dtype)
    pv[page, off] = v[:, 0].to(pv.dtype)
    table = page_table.long()
    ck = pk[table].reshape(B, S, pk.shape[2], pk.shape[3])
    cv = pv[table].reshape(B, S, pv.shape[2], pv.shape[3])
    valid = torch.arange(S, device=x1.device)[None, :] <= pvec[:, None]
    out = _sdpa(q, ck, cv, valid[:, None, :], cfg)
    return _proj_out(out, params["wo"]), pk, pv
