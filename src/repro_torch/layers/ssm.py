"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) layer. Twin of
``repro/layers/ssm.py``.

Block structure (per Mamba2):
  in_proj → [z, x, B, C, dt] → causal depthwise conv on (x,B,C) → SSD scan
  → gated RMSNorm with silu(z) → out_proj.

The SSD scan is the chunked dual form: the intra-chunk terms (the output
inside each chunk and each chunk's state) come from
``kernels/ssd.py::ssd_intra`` — the CUDA kernel on the card — and a Python
loop over the chunks carries the (H, P, N) state across them. Per-head
scalar decay a_t = exp(dt_t · A_h), A_h = −exp(A_log_h). The scan is
differentiable end to end: ``ssd_intra``'s gradient is the backward kernel
(``kernels/ssd.py::SSDIntraFn``), and the loop rebinds its state rather than
writing it in place, so autograd keeps each chunk's.

Decode is the O(1) recurrence: h ← a·h + dt·(B ⊗ x);  y = C·h + D·x. The
projections are ``torch.matmul``. On a mesh (DTensors) the scan runs per
device, each its rows and heads (``_ssd_per_device``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ssd_intra
from repro_torch.layers.initializers import dense_init, init_device
from repro_torch.utils import shard


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    dinner = s.expand * cfg.d_model
    H = dinner // s.head_dim
    return s, dinner, H, s.head_dim, s.n_groups, s.state_dim


def ssm_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             stack: Optional[int] = None):
    """One layer's params, or ``stack`` layers' along a leading axis."""
    s, dinner, H, P, G, N = _dims(cfg)
    conv_ch = dinner + 2 * G * N
    dev = init_device(generator)
    lead = () if stack is None else (stack,)
    # dt bias init so softplus(dt_bias) spans [1e-3, 1e-1] (mamba convention)
    u = torch.rand(lead + (H,), generator=generator, device=dev)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))                 # inverse softplus
    A_log = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
    return {
        "in_proj": dense_init(generator, (cfg.d_model, 2 * dinner + 2 * G * N + H),
                              dtype, stack=stack),
        "conv_w": dense_init(generator, (s.conv_width, conv_ch), dtype,
                             scale=0.5, stack=stack),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=dev),
        "A_log": A_log.expand(lead + (H,)).contiguous(),
        "D": torch.ones(lead + (H,), device=dev),
        "dt_bias": dt_bias,
        "norm_scale": torch.ones(lead + (dinner,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, (dinner, cfg.d_model), dtype,
                               stack=stack),
    }


def _split_proj(params, u, cfg: ModelConfig):
    s, dinner, H, P, G, N = _dims(cfg)
    proj = u @ params["in_proj"]
    z, xbc, dt = torch.split(proj, [dinner, dinner + 2 * G * N, H], dim=-1)
    return z, xbc, dt  # xbc = concat(x, B, C) — the conv channels


def _causal_conv(xbc, conv_w, conv_b, tail=None):
    """Depthwise causal conv. xbc (B, T, C); tail (B, W-1, C) left context.
    → (silu(conv), new tail (B, W-1, C))."""
    W = conv_w.shape[0]
    if tail is None:
        tail = xbc.new_zeros(xbc.shape[:1] + (W - 1,) + xbc.shape[2:])
    xp = torch.cat([tail.to(xbc.dtype), xbc], dim=1)             # (B, T+W-1, C)
    T = xbc.shape[1]
    out = xp[:, 0:T] * conv_w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + T] * conv_w[i]
    out = out + conv_b
    new_tail = xp[:, -(W - 1):] if W > 1 else tail
    return F.silu(out), new_tail


def _gated_norm(y, z, scale, eps=1e-6):
    y = y * F.silu(z.float())
    var = y.square().mean(dim=-1, keepdim=True)
    return y / torch.sqrt(var + eps) * scale.float()


def ssd_chunked(x, Bm, Cm, dt, A_log, D, chunk: int,
                dt_bias: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x  (B, T, H, P)   inputs per head
    Bm (B, T, G, N)   input maps;  Cm same — heads grouped G-way
    dt (B, T, H)      positive step sizes (softplus already applied), or
                      with ``dt_bias`` (H,) the raw ones: softplus(dt + bias)
    Returns y (B, T, H, P), final state (B, H, P, N).

    On DTensors the scan runs per device (``_ssd_per_device``).
    """
    if shard.any_dtensor(x, Bm, Cm, dt, A_log, D, dt_bias):
        return _ssd_per_device(x, Bm, Cm, dt, A_log, D, chunk, dt_bias)
    if dt_bias is not None:
        dt = F.softplus(dt.float() + dt_bias)
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (T + pad) // Q
    rep = H // G

    A = -torch.exp(A_log.float())                                 # (H,)
    dt = dt.float()
    dA = dt * A                                                   # (B, Tp, H)
    xw = x.float() * dt[..., None]                                # dt-weighted

    xc = xw.reshape(Bsz, nc, Q, H, P)
    Bc = Bm.float().reshape(Bsz, nc, Q, G, N).contiguous()
    Cc = Cm.float().reshape(Bsz, nc, Q, G, N).contiguous()
    l = torch.cumsum(dA.reshape(Bsz, nc, Q, H), dim=2)           # (B,nc,Q,H)

    # intra-chunk dual term and chunk states: the kernel
    y_intra, S = ssd_intra(xc.contiguous(), Bc, Cc, l.contiguous())
    S = S.transpose(-1, -2)                                       # (B,nc,H,P,N)
    a_chunk = torch.exp(l[:, :, -1, :])                           # (B,nc,H)

    # inter-chunk recurrence (sequential over nc): Hst ← a_chunk·Hst + S,
    # chunk c reads the state BEFORE it
    Ch = Cc.repeat_interleave(rep, dim=3)                         # (B,nc,Q,H,N)
    Hst = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("bqh,bqhn,bhpn->bqhp",
                                    torch.exp(l[:, c]), Ch[:, c], Hst))
        Hst = Hst * a_chunk[:, c, :, None, None] + S[:, c]
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(Bsz, T + pad, H, P)
    y = y + x.float() * D[None, None, :, None]
    if pad:
        y = y[:, :T]
    return y, Hst


def _ssd_per_device(x, Bm, Cm, dt, A_log, D, chunk: int, dt_bias=None):
    """``ssd_chunked`` on each device's shard, as GSPMD splits the
    reference's scan: the batch over the data axes where x splits it, the
    heads over "model" where they divide it and each device's heads read
    their own B/C groups (G divides it too, or G = 1). Every term of the
    scan is per (row, head), so no device reads another's. (DTensor has
    no sharding rule for softplus's backward: the softplus of ``dt_bias``
    runs here too.)"""
    from torch.distributed.tensor import Shard
    mesh = shard.mesh_of(x, Bm, Cm, dt, A_log, D)
    bp = shard.batch_placements(x, mesh)
    rep = shard.replicated(mesh)
    H, G = x.shape[2], Bm.shape[2]
    names = mesh.mesh_dim_names or ()
    m = names.index("model") if "model" in names else None
    if m is None or H % mesh.size(m) or (G > 1 and G % mesh.size(m)):
        pl = (bp, bp, bp, bp, rep, rep, rep)
        out = (bp, bp)
    else:
        def at(p, dim, split=True):
            return tuple(Shard(dim) if i == m and split else q
                         for i, q in enumerate(p))
        heads = at(bp, 2)
        pl = (heads, at(bp, 2, G > 1), at(bp, 2, G > 1), heads,
              at(rep, 0), at(rep, 0), at(rep, 0))
        out = (heads, at(bp, 1))
    return shard.per_device(
        lambda x, Bm, Cm, dt, A_log, D, dt_bias: ssd_chunked(
            x, Bm, Cm, dt, A_log, D, chunk, dt_bias),
        (x, Bm, Cm, dt, A_log, D, dt_bias), pl, out, mesh=mesh)


def ssm_forward(params, u, cfg: ModelConfig, conv_tail=None,
                state=None) -> Tuple[torch.Tensor, dict]:
    """Full-sequence Mamba2 block. u: (B, T, d) → (out, cache dict)."""
    s, dinner, H, P, G, N = _dims(cfg)
    z, xbc, dt = _split_proj(params, u, cfg)
    xbc, new_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_tail)
    x, Bm, Cm = torch.split(xbc, [dinner, G * N, G * N], dim=-1)
    Bsz, T = u.shape[0], u.shape[1]
    x = x.reshape(Bsz, T, H, P)
    Bm = Bm.reshape(Bsz, T, G, N)
    Cm = Cm.reshape(Bsz, T, G, N)
    y, fin = ssd_chunked(x, Bm, Cm, dt, params["A_log"], params["D"], s.chunk,
                         dt_bias=params["dt_bias"])
    y = _gated_norm(y.reshape(Bsz, T, dinner), z, params["norm_scale"])
    out = y.to(u.dtype) @ params["out_proj"]
    return out, {"conv_tail": new_tail, "state": fin}


def ssm_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None, stack: Optional[int] = None):
    """Conv tail (B, W-1, C) in ``dtype`` and SSM state (B, H, P, N) f32,
    or ``stack`` of each along a leading axis."""
    s, dinner, H, P, G, N = _dims(cfg)
    conv_ch = dinner + 2 * G * N
    lead = () if stack is None else (stack,)
    return {
        "conv_tail": torch.zeros(lead + (batch, s.conv_width - 1, conv_ch),
                                 dtype=dtype, device=device),
        "state": torch.zeros(lead + (batch, H, P, N), dtype=torch.float32,
                             device=device),
    }


def ssm_decode_step(params, u1, cache, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, dict]:
    """One-token decode. u1: (B, 1, d). O(1) state update → (out, new cache)."""
    s, dinner, H, P, G, N = _dims(cfg)
    z, xbc, dt = _split_proj(params, u1, cfg)
    xbc, new_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 cache["conv_tail"])
    x, Bm, Cm = torch.split(xbc[:, 0], [dinner, G * N, G * N], dim=-1)
    Bsz = u1.shape[0]
    x = x.reshape(Bsz, H, P).float()
    Bm = Bm.reshape(Bsz, G, N).repeat_interleave(H // G, dim=1).float()
    Cm = Cm.reshape(Bsz, G, N).repeat_interleave(H // G, dim=1).float()
    dt1 = F.softplus(dt[:, 0].float() + params["dt_bias"])        # (B, H)
    a = torch.exp(dt1 * -torch.exp(params["A_log"]))              # (B, H)
    h = cache["state"] * a[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt1, x, Bm)
    y = torch.einsum("bhn,bhpn->bhp", Cm, h) + x * params["D"][None, :, None]
    y = _gated_norm(y.reshape(Bsz, 1, dinner), z, params["norm_scale"])
    out = y.to(u1.dtype) @ params["out_proj"]
    return out, {"conv_tail": new_tail, "state": h}
