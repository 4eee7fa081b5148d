"""The step functions the launchers run and the dry run counts. Twin of
``repro/launch/steps.py``, for every family (lstm, dense, moe, ssm, hybrid,
vlm, audio):

  train_step    — fwd + bwd + global-norm clip + AdamW (a moe model's loss
                  carries its load-balance aux, ``models/lm.py::train_loss``)
  prefill_step  — full-sequence forward + last-position top-k logits
  serve_step    — ONE-token decode against a deep cache; two heads:
                    'full' : exact softmax over the whole vocab
                    'l2s'  : the paper's screened softmax, through the
                             port's route kernel and fused top-k kernel

Forward and backward run through ``torch.autograd`` over the port's torch
layers (PyTorch's float32 products stay IEEE float32: ``resolve_device``
turns TF32 off; the SSD backward kernel splits its products in TF32 to
float32 grade); on the card the SSM layers' intra-chunk terms run through
``kernels/ssd.py``'s kernels, forward and backward, and attention decode
writes its cache through ``kernels/cache_update.py``. ``abstract_*`` give
the steps' arguments on the ``meta`` device (shapes and dtypes, no
storage: the reference's ``ShapeDtypeStruct``s), which
``launch/dryrun.py`` counts one step over.

Where the l2s serve step differs from the reference's: the reference
inlines a word-granular jnp gather over ``cand_idx`` (r, C_max); the port
runs ``kernels/ops.py::screened_fused_topk`` (route kernel, then the fused
kernel) over a 128-word block screen ``cand_blocks`` (r, K), sentinel
n_blk, with v in float32 (the kernels' dtype; ``fit_l2s`` makes it so).
The head is packed into 128-row tiles by views where the vocabulary is a
multiple of 128, else padded by a copy each step, which the dry run then
counts (phi3.5-moe's and mamba2-1.3b's vocabularies).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import V_BLK, L2SConfig, ModelConfig, TrainConfig
from repro_torch.kernels.ops import pack_head_blocks, screened_fused_topk
from repro_torch.kernels.ref import topk_desc
from repro_torch.launch import op_cost
from repro_torch.models.lm import train_loss
from repro_torch.models.model import Model
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule)
from repro_torch.tree import tree_flatten, tree_unflatten
from repro_torch.utils import shard

TOPK = 5


def loss_and_grads(model: Model, tcfg: TrainConfig, params,
                   batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, dict]:
    """(mean loss, float32 gradients as a params tree) of one global batch;
    ``tcfg.microbatch = m`` splits it into m sequential microbatches whose
    losses and gradients are summed, then divided by m."""
    leaves = tree_flatten(params)

    def one(mb) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = train_loss(model, tree_unflatten(params, live), mb,
                              loss_chunk=tcfg.loss_chunk,
                              remat=(tcfg.remat == "block"))
            # a leaf the loss does not read (the audio encoder's token
            # embedding) gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(live, grads)]

    m = tcfg.microbatch
    if m is None or m <= 1:
        loss, grads = one(batch)
    else:
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        for i in op_cost.trips(m, leaves[0]):
            l, g = one({k: _microbatch(x, i, m) for k, x in batch.items()})
            loss = loss + l
            grads = [a + b.float() for a, b in zip(grads, g)]
        loss = loss / m
        grads = [g / m for g in grads]
    return loss, tree_unflatten(params, grads)


def _microbatch(x: torch.Tensor, i: int, m: int) -> torch.Tensor:
    """Rows [i·n, (i + 1)·n) of x, n = B / m. A DTensor split over the
    batch gives each device's i-th m-th of its own rows instead: the same
    rows over the m microbatches, no row sent (the reference reshapes the
    batch to (m, B / m) and lets GSPMD shard each microbatch)."""
    if not shard.is_dtensor(x):
        n = x.shape[0] // m
        return x[i * n:(i + 1) * n]
    bp = shard.batch_placements(x, x.device_mesh)
    return shard.per_device(
        lambda t: t[i * (t.shape[0] // m):(i + 1) * (t.shape[0] // m)],
        (x,), (bp,), (bp,))


def make_train_step(model: Model, tcfg: TrainConfig, donate: bool = False):
    """fwd + bwd + global-norm clip + AdamW: ``train_step(params, opt_state,
    batch) → (params, opt_state, {"loss", "gnorm"})``, the batch a dict of
    tensors on the params' device. ``donate=True`` updates ``params`` and
    ``opt_state``'s moments in place (the caller gives them up, as to a
    jitted step with donated buffers): a float32 zamba2-2.7b step then holds
    one copy of params and moments (3 × 9.26 GB) instead of old and new
    ones."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, tcfg, params, batch)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        # schedule off the 1-based step (the 0-based pre-update counter would
        # make the first step a warmup no-op)
        lr = cosine_schedule(opt_state.step + 1, tcfg.lr, tcfg.warmup_steps,
                             tcfg.total_steps)
        params, opt_state = adamw_update(grads, opt_state, params, lr,
                                         tcfg.b1, tcfg.b2,
                                         weight_decay=tcfg.weight_decay,
                                         donate=donate)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}
    return train_step


def default_microbatches(cfg: ModelConfig, global_batch: int, seq_len: int,
                         data_shards: int, budget_bytes: float = 6e9
                         ) -> Optional[int]:
    """Pick a microbatch count so rematted residuals (L·B_loc·T·d·2 bytes)
    fit the activation budget. Returns None when no split is needed."""
    b_loc = max(global_batch // max(data_shards, 1), 1)
    resid = 2.0 * cfg.num_layers * b_loc * seq_len * cfg.d_model
    m = 1
    while resid / m > budget_bytes and m < b_loc:
        m *= 2
    while global_batch % m:
        m //= 2
    return m if m > 1 else None


def make_prefill_step(model: Model):
    """``prefill_step(params, batch) → (ids (B, TOPK) int32, vals (B,
    TOPK) f32)``: the forward over the batch and the top-k of the last
    position's full logits."""
    def prefill_step(params, batch):
        h, _ = model.forward(params, batch)
        logits = model.logits(params, h[:, -1])          # last position only
        vals, ids = topk_desc(logits.float(), TOPK)
        return ids.to(torch.int32), vals
    return prefill_step


def windowed(model: Model, window: Optional[int]) -> Model:
    """``model`` with attention over a ring of ``window`` slots (the long
    context's sliding-window variant), or ``model`` itself."""
    if window == model.cfg.sliding_window or not model.cfg.supports_decode:
        return model
    return Model(replace(model.cfg, sliding_window=window))


def _head_blocks(W: torch.Tensor, b: torch.Tensor):
    """(L, d), (L,) → 128-row tiles: views where L is a multiple of V_BLK,
    else the padded copy of ``pack_head_blocks``. On a mesh a vocab split
    the tiles cannot follow (the tiles do not divide over it, or the head
    is padded) is gathered first."""
    L, d = W.shape
    n_blk = L // V_BLK if L % V_BLK == 0 else 0
    W, b = shard.gather_split(W, 0, n_blk), shard.gather_split(b, 0, n_blk)
    if L % V_BLK:
        return pack_head_blocks(W, b)
    return shard.tiles(W, V_BLK), shard.tiles(b, V_BLK)


def make_serve_step(model: Model, head: str = "full",
                    window: Optional[int] = None):
    """head: 'full' | 'l2s'; ``window`` the decode's ring (see
    ``windowed``). Signature:
       full: (params, cache, token, pos) → (ids, vals, cache)
       l2s:  (params, screen_v, cand_blocks, cache, token, pos)
             → (ids, vals, cache)
    the cache updated in place (attention through the cache kernel)."""
    model = windowed(model, window)

    if head == "full":
        def serve_step(params, cache, token, pos):
            h, cache = model.decode_step(params, token, cache, pos)
            logits = model.logits(params, h)
            vals, ids = topk_desc(logits.float(), TOPK)
            return ids.to(torch.int32), vals, cache
        return serve_step
    if head != "l2s":
        raise ValueError(f"head must be 'full' or 'l2s', got {head!r}")

    def serve_step_l2s(params, screen_v, cand_blocks, cache, token, pos):
        h, cache = model.decode_step(params, token, cache, pos)
        Wb, bb = _head_blocks(*model.softmax_weights(params))
        ids, vals, _ = screened_fused_topk(Wb, bb, screen_v, cand_blocks,
                                           h.to(Wb.dtype), k=TOPK)
        return ids, vals, cache
    return serve_step_l2s


def abstract_screen(cfg: ModelConfig, l2s: L2SConfig):
    """The l2s serve step's screen on the meta device: v (r, d) float32
    and cand_blocks (r, K) int32, K the 128-word blocks of the reference's
    padded candidate capacity (its budget × 2, rounded up to 8 words)."""
    r = l2s.num_clusters
    c_max = max(8, -(-int(l2s.budget * 2) // 8) * 8)
    K = -(-c_max // V_BLK)
    return (torch.empty((r, cfg.d_model), dtype=torch.float32, device="meta"),
            torch.empty((r, K), dtype=torch.int32, device="meta"))


def abstract_cache(model: Model, batch: int, max_len: int,
                   window: Optional[int] = None, dtype=torch.bfloat16):
    """The decode cache of ``batch`` rows and ``max_len`` slots (a ring of
    ``window`` slots where given) on the meta device."""
    return windowed(model, window).init_cache(batch, max_len, dtype=dtype,
                                              device="meta")


def abstract_params(model: Model):
    return model.init(None, device="meta")


def abstract_opt_state(aparams):
    return adamw_init(aparams)
