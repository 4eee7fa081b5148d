"""L2S — Algorithm 1, end-to-end training of the screening model. Twin of
``repro/core/train_l2s.py``.

Alternating minimization of Eq.(7):
  v-step: SGD on Eq.(8) through the Gumbel-ST relaxation, on the device.
          With candidate masks fixed and binary, the per-sample per-cluster
          loss is
            loss_{i,t} = (k − hits_{i,t}) + λ·(|c_t|·block − hits_{i,t})
          where hits_{i,t} = |y_i ∩ c_t|; the sample's loss is Σ_t p̄_t·loss_t
          (p̄ = straight-through one-hot), plus γ·max(0, L̄_mov − B) with a
          moving-average L̄ (paper: mini-batch moving average). The gradient
          comes from ``torch.autograd.grad``.
  c-step: greedy knapsack (``core/knapsack.py``), numpy on the host.

``collect_contexts`` runs the trained LM over a corpus to harvest (h, y):
y = exact-softmax top-k ids — the paper trains the screen to mimic the full
softmax, not the data labels.

Randomness: the k-means seed row, each v-step's batch rows and its Gumbel
noise come from one ``torch.Generator`` on the fitting device, seeded from
``cfg.seed``; the 50,000-row k-means subsample is the reference's numpy
draw. The two frameworks' generators differ, so every draw can also come
from the caller: ``spherical_kmeans``'s seed row, ``_vstep_batch``'s noise,
and ``fit_l2s``'s seed row and per-step batch rows and noise (``first``,
``batches``). Handed the reference's draws, a fit follows the reference's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import L2SConfig
from repro_torch.core.gumbel import gumbel_softmax_st
from repro_torch.core.kmeans import spherical_kmeans
from repro_torch.core.knapsack import candidate_stats, greedy_knapsack
from repro_torch.core.screening import (ScreenParams, assign_clusters,
                                        candidates_to_padded)
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import topk_desc


@dataclass
class L2SState:
    screen: ScreenParams
    mask: np.ndarray            # (r, n_items) bool — current candidate sets
    history: list               # per-round dicts: loss, L̄, coverage, and the
                                # host-clock seconds of its c-step and of a
                                # v-step (the round's v-steps end in a sync)


def collect_contexts(model, params, token_batches, max_vectors: int = 200_000,
                     k: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Harvest (H (N, d), y (N, k)) from an LM over token batches (tensors
    on the params' device).

    y_i = exact softmax top-k at each position (paper Algorithm 1 line 2),
    ties to the lowest id (``topk_desc``, the reference's ``top_k`` order).
    """
    W, b = model.softmax_weights(params)
    Hs, ys = [], []
    n = 0
    with torch.inference_mode():
        for tokens in token_batches:
            h, _ = model.forward(params, {"tokens": tokens})
            d = h.shape[-1]
            h = h.reshape(-1, d)
            _, top = topk_desc(h @ W.T + b, k)
            Hs.append(h.float().cpu().numpy())
            ys.append(top.to(torch.int32).cpu().numpy())
            n += Hs[-1].shape[0]
            if n >= max_vectors:
                break
    H = np.concatenate(Hs)[:max_vectors]
    y = np.concatenate(ys)[:max_vectors]
    return H, y


# -- v-step -------------------------------------------------------------------

def _vstep_batch(v: torch.Tensor, h: torch.Tensor,
                 hits_per_cluster: torch.Tensor, cand_words: torch.Tensor,
                 lbar_mov: torch.Tensor, cfg_budget: float, cfg_lamb: float,
                 cfg_gamma: float, cfg_temp: float, cfg_k: int, lr: float,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None):
    """One SGD step on Eq.(8). → (new v, loss, moving L̄).

    h: (B, d) the batch's contexts; hits_per_cluster: (B, r) — |y_i ∩ c_t|
    (c fixed); cand_words: (r,) — candidate set sizes |c_t| in words;
    ``noise``: the (B, r) Gumbel noise, else drawn from ``generator``.
    """
    v = v.detach().requires_grad_(True)
    with torch.enable_grad():
        logits = h @ v.T                                    # log P(t|h) ∝ v_t·h
        p_bar, _ = gumbel_softmax_st(logits, cfg_temp, generator, noise)
        miss = cfg_k - hits_per_cluster                     # (B, r)
        fp = cfg_lamb * (cand_words[None, :] - hits_per_cluster)
        per_cluster = miss + fp
        sample_loss = torch.sum(p_bar * per_cluster, dim=-1)
        # moving-average label size constraint (Lagrangian, Eq.(8))
        lbar_batch = torch.mean(torch.sum(p_bar * cand_words[None, :], dim=-1))
        lbar = 0.9 * lbar_mov + 0.1 * lbar_batch
        penalty = cfg_gamma * torch.clamp(lbar - cfg_budget, min=0.0)
        loss = torch.mean(sample_loss) + penalty
        (grad,) = torch.autograd.grad(loss, v)
    return (v - lr * grad).detach(), loss.detach(), lbar.detach()


def _hits_matrix(mask_dev: torch.Tensor, y: torch.Tensor, block: int
                 ) -> torch.Tensor:
    """hits_{i,t} = |y_i ∩ c_t|. mask_dev (r, n_items) float; y (B, k) word
    ids. → (B, r)."""
    items = y // block if block > 1 else y               # (B, k)
    sel = mask_dev[:, items.long()]                      # (r, B, k)
    return torch.sum(sel, dim=-1).T


# -- full Algorithm 1 ----------------------------------------------------------

def _kmeans_init(H: np.ndarray, cfg: L2SConfig, generator: torch.Generator,
                 device: torch.device, first: Optional[int]) -> torch.Tensor:
    """Algorithm 1 line 3 on the reference's 50,000-row numpy subsample;
    ``first`` seeds the maximin init (a row of the subsample)."""
    N = H.shape[0]
    sub = H[np.random.default_rng(cfg.seed).choice(N, min(N, 50_000),
                                                   replace=False)]
    return spherical_kmeans(torch.as_tensor(sub, device=device),
                            cfg.num_clusters, generator, first=first)


def _screen(v: torch.Tensor, mask: np.ndarray, vocab_size: int,
            block: int) -> ScreenParams:
    idx, lens = candidates_to_padded(mask, vocab_size, block)
    dev = v.device
    return ScreenParams(v=v.contiguous(),
                        cand_idx=torch.as_tensor(idx, device=dev),
                        cand_len=torch.as_tensor(lens, device=dev),
                        vocab_size=vocab_size, block=block)


def fit_l2s(H: np.ndarray, y: np.ndarray, vocab_size: int, cfg: L2SConfig,
            verbose: bool = False, eval_fn: Optional[Callable] = None,
            device="cuda", first: Optional[int] = None,
            batches: Optional[Iterable[Tuple]] = None) -> L2SState:
    """Train the screening model on harvested (H, y). The v-steps run on
    ``device`` ("cuda" by default; raises without a GPU unless the caller
    passes device="cpu"); the c-steps run in numpy. The screen comes back
    on ``device``.

    ``first`` and ``batches`` hand in the draws instead of the generator:
    the k-means seed row, and for each v-step in order its batch's row
    indices (batch_size,) and Gumbel noise (batch_size, r)."""
    dev = resolve_device(device)
    N, d = H.shape
    k = y.shape[1]
    r = cfg.num_clusters
    block = cfg.vocab_block
    n_items = -(-vocab_size // block)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    v = _kmeans_init(H, cfg, gen, dev, first)
    steps = None if batches is None else iter(batches)
    Hd = torch.as_tensor(H, device=dev)
    yd = torch.as_tensor(y, device=dev)
    items_np = y // block if block > 1 else y

    history = []
    lbar_mov = torch.zeros((), dtype=torch.float32, device=dev)

    def cstep(v_cur):
        """Knapsack under the current assignments → (mask, coverage).
        coverage = mean fraction of true top-k captured — the quantity P@k
        tracks; used for best-round selection."""
        assign = assign_clusters(v_cur, Hd).cpu().numpy()
        counts, csizes = candidate_stats(assign, y, r, vocab_size, block)
        m = greedy_knapsack(counts, csizes, N, cfg.budget, cfg.lamb,
                            vocab_size, block)
        hits = m[assign][np.arange(N)[:, None], items_np].sum()
        return m, float(hits) / (N * k)

    # round 0's (v, c) is exactly the spherical-kmeans screen; keep the BEST
    # round overall so the end-to-end refinement can never underperform its
    # own init
    best = {"v": v, "mask": None, "cov": -1.0}

    for round_i in range(cfg.outer_iters):
        # ---- c-step: knapsack under the CURRENT assignments ----
        t0 = time.perf_counter()
        mask, cov = cstep(v)
        t1 = time.perf_counter()
        if cov > best["cov"]:
            best = {"v": v, "mask": mask, "cov": cov}
        mask_dev = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        cand_words = torch.as_tensor(mask.sum(axis=1) * block,
                                     dtype=torch.float32, device=dev)

        # ---- v-step: SGD with Gumbel-ST ----
        losses = []
        for _ in range(cfg.sgd_steps):
            if steps is None:
                idx = torch.randint(N, (cfg.batch_size,), generator=gen,
                                    device=dev)
                noise = None
            else:
                idx, noise = (torch.as_tensor(x, device=dev)
                              for x in next(steps))
            idx = idx.long()
            hits = _hits_matrix(mask_dev, yd[idx], block)
            v, loss, lbar_mov = _vstep_batch(
                v, Hd[idx], hits, cand_words, lbar_mov, float(cfg.budget),
                cfg.lamb, cfg.gamma, cfg.gumbel_temp, k, cfg.lr,
                generator=gen, noise=noise)
            losses.append(loss)

        rec = {"round": round_i,
               "loss": float(torch.stack(losses[-20:]).mean()),
               "lbar": float(lbar_mov), "coverage": cov,
               "cstep_s": t1 - t0,
               "vstep_s": (time.perf_counter() - t1) / max(cfg.sgd_steps, 1)}
        if eval_fn is not None:
            rec.update(eval_fn(v, mask))
        history.append(rec)
        if verbose:
            print(f"[l2s] round {round_i}: {rec}")

    # final c-step on converged assignments; select the best round
    mask, cov = cstep(v)
    if cov > best["cov"]:
        best = {"v": v, "mask": mask, "cov": cov}
    history.append({"round": "final", "coverage_best": best["cov"]})
    return L2SState(screen=_screen(best["v"], best["mask"], vocab_size, block),
                    mask=best["mask"], history=history)


def kmeans_only_screen(H: np.ndarray, y: np.ndarray, vocab_size: int,
                       cfg: L2SConfig, device="cuda",
                       first: Optional[int] = None) -> L2SState:
    """Table-4 ablation: spherical k-means clusters + one knapsack c-step
    (no Gumbel end-to-end refinement), on ``device``; ``first`` as in
    ``fit_l2s``."""
    dev = resolve_device(device)
    N = H.shape[0]
    r, block = cfg.num_clusters, cfg.vocab_block
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    v = _kmeans_init(H, cfg, gen, dev, first)
    assign = assign_clusters(v, torch.as_tensor(H, device=dev)).cpu().numpy()
    counts, csizes = candidate_stats(assign, y, r, vocab_size, block)
    mask = greedy_knapsack(counts, csizes, N, cfg.budget, cfg.lamb,
                           vocab_size, block)
    return L2SState(screen=_screen(v, mask, vocab_size, block), mask=mask,
                    history=[])
