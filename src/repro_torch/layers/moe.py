"""Mixture-of-Experts layer: top-k router + capacity-bounded dispatch. Twin
of ``repro/layers/moe.py``.

  * router logits (T, E) in float32; top-k gates renormalised over the
    chosen experts (the Mixtral convention). The top-k is
    ``kernels/ref.py::topk_desc``, ties to the lowest expert id as
    ``jax.lax.top_k`` breaks them (``torch.topk`` does not promise that).
  * grouped dispatch: each batch row is one routing group, with capacity
    C = ceil(cf · T · k / E) slots an expert (at least 8, rounded up to 8).
    A slot's place in its expert is a cumsum in token-major, k-minor slot
    order; a slot at or past C is dropped (combine weight 0). The kept
    tokens are scatter-added into (B, E, C, d) buffers, every expert runs
    over its C slots in one batched product over the stacked (E, d, ff)
    weights, and the combine adds each token's K slot outputs in slot
    order. The rows of a batch never meet, so a B = 1 prefill equals its
    row of a wider one.
  * aux load-balance loss (Switch): aux_loss_weight · E · Σ_e f_e · p_e.

The expert products are ``torch.matmul`` over the stacked weights: the
reference computes them as einsums outside any Pallas kernel. At decode
(T = 1) every expert runs over its 8-slot buffer, as in the reference, so a
step reads every expert's weights.

On a mesh (DTensors) the rows never meeting makes the layer a per-device
one (``_moe_per_device``): each device routes, dispatches and combines its
own rows; its experts are the ones "model" gives it (all of them, their ff
slice, or E / m whole experts under expert parallelism) and its output a
partial sum over "model" where they are split. The reference's
``shard_batch`` pins of the dispatch buffers (``buf0``, ``out``; T > 1)
hold each device's buffer to its own rows; the load-balance statistics
are summed over the devices.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import topk_desc
from repro_torch.layers.initializers import dense_init
from repro_torch.layers.mlp import GATED
from repro_torch.utils import shard


def moe_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             stack: Optional[int] = None):
    """One layer's router and stacked experts, or ``stack`` layers' along
    a leading axis."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    kw = dict(stack=stack)
    p = {"w_router": dense_init(generator, (d, E), dtype, **kw)}
    if cfg.mlp_activation in GATED:
        p["w_gate"] = dense_init(generator, (E, d, ff), dtype, **kw)
    p["w_up"] = dense_init(generator, (E, d, ff), dtype, **kw)
    p["w_down"] = dense_init(generator, (E, ff, d), dtype, **kw)
    return p


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """Slots an expert has in one group: ceil(cf · T · k / E), at least 8
    and rounded up to a multiple of 8."""
    m = cfg.moe
    c = int(math.ceil(m.capacity_factor * tokens_per_group * m.top_k
                      / m.num_experts))
    return max(8, -(-c // 8) * 8)


def _route(params, xt: torch.Tensor, cfg: ModelConfig):
    """xt (N, d) → gates (N, K) float32, experts (N, K) int64, probs (N, E)
    float32."""
    logits = (xt @ params["w_router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = topk_desc(probs, cfg.moe.top_k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    return gate_vals, expert_idx, probs


def _slots(expert_idx: torch.Tensor, E: int, C: int):
    """expert_idx (B, T·K) → (each slot's place in its expert, kept), the
    place from a cumsum over the group's slots in token-major, k-minor
    order."""
    onehot = F.one_hot(expert_idx, E)                       # (B, T·K, E)
    place = torch.sum((torch.cumsum(onehot, dim=1) - onehot) * onehot, dim=-1)
    return place, place < C


def _experts(params, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """buf (B, E, C, d) → every expert's FFN over its own C slots, (B, E,
    C, d): one product batched over the E stacked weights."""
    B, E, C, d = buf.shape
    xe = buf.transpose(0, 1).reshape(E, B * C, d)
    act = cfg.mlp_activation
    if act in GATED:
        g = torch.matmul(xe, params["w_gate"])
        u = torch.matmul(xe, params["w_up"])
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * u
    else:
        h = F.gelu(torch.matmul(xe, params["w_up"]), approximate="tanh")
    out = torch.matmul(h, params["w_down"])                 # (E, B·C, d)
    return out.reshape(E, B, C, d).transpose(0, 1)


def moe_apply(params, x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) → (out (B, T, d), aux loss, a 0-dim float32 tensor).
    Each batch row is one routing group."""
    if shard.any_dtensor(x, *params.values()):
        return _moe_per_device(params, x, cfg)
    E = cfg.moe.num_experts
    out, expert_idx, probs = _dispatch_combine(params, x, cfg, 0)
    frac = torch.mean(F.one_hot(expert_idx[:, 0], E).float(), dim=0)
    aux = (cfg.moe.aux_loss_weight * E) * torch.sum(
        frac * torch.mean(probs, dim=0))
    return out, aux


def _dispatch_combine(params, x: torch.Tensor, cfg: ModelConfig,
                      e_off: int):
    """x's rows through the experts ``params`` holds, experts [e_off,
    e_off + E_loc) of the E (all of them, their ff slice, or a device's
    whole experts under expert parallelism; a slot routed to another
    device's expert is dropped here) → (out (B, T, d), the sum over those
    experts; each token's experts (B·T, K) and router probabilities (B·T,
    E))."""
    B, T, d = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    E_loc = params["w_up"].shape[0]
    C = capacity(T, cfg)
    gate_vals, expert_idx, probs = _route(params, x.reshape(B * T, d), cfg)
    flat_e = expert_idx.reshape(B, T * K)
    place, keep = _slots(flat_e, E, C)
    local_e = flat_e
    if E_loc < E:                  # expert parallel: this device's experts
        local_e = flat_e - e_off
        keep = keep & (local_e >= 0) & (local_e < E_loc)
        local_e = torch.where(keep, local_e, 0)
    flat_g = torch.where(keep, gate_vals.reshape(B, T * K), 0.0)
    safe_p = torch.where(keep, place, 0)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, T * K)
    # each token once per slot, token-major (an expand: no host sync)
    contrib = x[:, :, None].expand(B, T, K, d).reshape(B, T * K, d) * \
        keep[..., None].to(x.dtype)
    buf = torch.zeros((B, E_loc, C, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((rows, local_e, safe_p), contrib, accumulate=True)
    out_buf = _experts(params, buf, cfg)
    slot_out = (out_buf[rows, local_e, safe_p] *
                flat_g[..., None].to(x.dtype)).reshape(B, T, K, d)
    out = torch.zeros_like(x)
    for j in range(K):                     # the combine's adds, in slot order
        out = out + slot_out[:, :, j]
    return out, expert_idx, probs


def _moe_per_device(params, x, cfg: ModelConfig):
    """``moe_apply`` on DTensors: each device's rows (x batch-split over
    the data axes) through its experts, their weights gathered over the
    data axes (FSDP) and split over "model" as placed (expert parallel,
    ff, or not at all); the output a partial sum over "model" where it
    splits them; every gradient a partial sum over the devices that share
    its tensor (``shard.per_device``). The aux loss from the statistics
    summed over the devices."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = shard.mesh_of(x, *params.values())
    names = mesh.mesh_dim_names or ()
    m = names.index("model") if "model" in names else None
    bp = shard.batch_placements(x, mesh)
    rep = shard.replicated(mesh)
    B, T, _ = x.shape
    E = cfg.moe.num_experts
    w_pl, e_split, split = {}, False, False
    for k, w in params.items():
        p = rep
        if m is not None and k != "w_router" and shard.is_dtensor(w) and \
                isinstance(w.placements[m], Shard):
            p = tuple(w.placements[m] if i == m else Replicate()
                      for i in range(mesh.ndim))
            split = True
            e_split = e_split or w.placements[m].dim == 0
        w_pl[k] = p
    e_off = 0
    if e_split:
        E_loc = E // mesh.size(m)
        e_off = mesh.get_coordinate()[m] * E_loc
    out_pl = tuple(Partial() if split and i == m else p
                   for i, p in enumerate(bp))
    stat_pl = tuple(Partial() if p == Shard(0) else Replicate() for p in bp)
    # where the experts split, the router's gradient is a partial sum over
    # "model" (each device's gates are its experts'), so each device's
    # probabilities count 1 / m of the aux term (m a power of two: exact)
    prob_pl = tuple(Partial() if split and i == m else p
                    for i, p in enumerate(stat_pl))
    frac = 1.0 / mesh.size(m) if split else 1.0
    keys = list(params)

    def local(x, *ws):
        out, expert_idx, probs = _dispatch_combine(dict(zip(keys, ws)), x,
                                                   cfg, e_off)
        counts = torch.sum(F.one_hot(expert_idx[:, 0], E).float(), dim=0)
        return out, counts, torch.sum(probs, dim=0) * frac
    out, counts, psum = shard.per_device(
        local, (x, *params.values()), (bp, *(w_pl[k] for k in keys)),
        (out_pl, stat_pl, prob_pl), mesh=mesh)
    if T > 1:
        out = shard.shard_batch(out)
    aux = (cfg.moe.aux_loss_weight * E) * torch.sum(
        (counts / (B * T)) * (psum / (B * T)))
    return out, aux
