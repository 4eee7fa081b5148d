"""Adapter heads wrapping the §4.1 competitor methods
(``repro_torch.core.baselines``) behind the ``SoftmaxHead`` protocol. Twin
of ``repro/heads/adapters.py``.

The wrapped methods are numpy, one query at a time (the paper's
single-thread CPU timing protocol), so these heads report
``device_kind = "numpy"`` and ``is_jittable = False``: the serving engine
replays the model's decode step on the card and runs the head on the host
between replays. A head takes ``h`` on any device and returns its tensors on
that device.

Candidate-space convention: a retrieval baseline exposes no fixed candidate
set, so ``topk_logprobs`` normalizes over a size-``norm_pool`` retrieved
shortlist (the method's own rerank pool truncated to a fixed width) — the
same "probability 0 outside the reduced space" convention as the screened
heads, with the pool as the candidate set. ``sample`` draws from that
shortlist, its Gumbel noise ((B, pool), ``noise_shape``) from the caller's
``torch.Generator``, through ``sample_from_logits``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import (AdaptiveShortlist, GreedyMIPS,
                                        LSHMIPS, PCAMIPS, SVDSoftmax)
from repro_torch.heads.base import (NEG_INF, SoftmaxHead, require_screen,
                                    sample_from_logits,
                                    screened_flops_per_query)


def _host(x) -> np.ndarray:
    """A tensor (any device) or array → a numpy array on the host; a
    bfloat16 tensor is widened to float32 (exactly: numpy has no bfloat16
    here), where the reference's numpy promotes it in its first product."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def _device(h) -> torch.device:
    return h.device if isinstance(h, torch.Tensor) else torch.device("cpu")


class BaselineHead(SoftmaxHead):
    """Generic adapter: any object with ``.topk(H (N, d), k) -> (N, k) ids``
    (−1 or ≥ L marking missing candidates) becomes a SoftmaxHead."""

    device_kind = "numpy"
    is_jittable = False

    def __init__(self, impl, W, b, name: str, norm_pool: int = 64):
        self.impl = impl
        self.W = _host(W)
        self.b = _host(b)
        self.name = name
        self.norm_pool = norm_pool

    def _topk(self, h, k: int):
        """numpy (ids (B, k) int32 with sentinel L for missing candidates,
        scores (B, k) with NEG_INF at sentinel slots), best-first: rows are
        re-sorted by score so valid candidates always precede sentinels."""
        H = np.asarray(_host(h), np.float32)
        ids = np.asarray(self.impl.topk(H, k))
        L = self.W.shape[0]
        valid = (ids >= 0) & (ids < L)
        safe = np.where(valid, ids, 0)
        scores = np.einsum("bkd,bd->bk", self.W[safe], H) + self.b[safe]
        scores = np.where(valid, scores, NEG_INF).astype(np.float32)
        ids = np.where(valid, ids, L).astype(np.int32)
        order = np.argsort(-scores, axis=1, kind="stable")
        return (np.take_along_axis(ids, order, axis=1),
                np.take_along_axis(scores, order, axis=1))

    def topk(self, h, k: int):
        ids, scores = self._topk(h, k)
        dev = _device(h)
        return torch.from_numpy(ids).to(dev), torch.from_numpy(scores).to(dev)

    def topk_logprobs(self, h, k: int):
        pool = max(k, min(self.norm_pool, self.W.shape[0]))
        ids, scores = self._topk(h, pool)
        shift = scores - scores.max(axis=-1, keepdims=True)
        lp = shift - np.log(np.exp(shift).sum(axis=-1, keepdims=True))
        # all-sentinel rows: the max shift cancels NEG_INF — re-mask so a
        # nonexistent word never carries probability mass
        lp = np.where(ids < self.W.shape[0], lp, NEG_INF)
        dev = _device(h)
        return (torch.from_numpy(np.ascontiguousarray(ids[:, :k])).to(dev),
                torch.from_numpy(np.ascontiguousarray(
                    lp[:, :k].astype(np.float32))).to(dev))

    def _in_vocab(self, ids: np.ndarray, h) -> torch.Tensor:
        # an empty retrieval pool (e.g. no LSH bucket hit) falls back to
        # token 0 rather than emitting the out-of-vocab sentinel
        ids = np.where(ids < self.W.shape[0], ids, 0).astype(np.int32)
        return torch.from_numpy(ids).to(_device(h))

    def next(self, h):
        return self._in_vocab(self._topk(h, 1)[0][:, 0], h)

    def sample(self, h, temperature: float = 1.0, top_p: float = 1.0,
               generator=None, gumbel=None):
        pool = min(self.norm_pool, self.W.shape[0])
        ids, scores = self._topk(h, pool)
        noise = self.noise(h, temperature, generator, gumbel)
        choice = sample_from_logits(torch.from_numpy(scores), temperature,
                                    top_p,
                                    None if noise is None else noise.cpu())
        picked = np.take_along_axis(ids, choice.numpy()[:, None].astype(
            np.int64), axis=-1)[:, 0]
        return self._in_vocab(picked, h)

    def noise_shape(self, batch: int, temperature: float):
        if temperature <= 0:
            return None
        return (batch, min(self.norm_pool, self.W.shape[0]))

    @property
    def memory_bytes(self) -> int:
        """W and b (host arrays) and the screen's tensors, if any."""
        total = int(self.W.nbytes + self.b.nbytes)
        screen = getattr(self, "screen", None)
        if screen is not None:
            total += sum(int(t.nbytes) for t in (screen.v, screen.cand_idx,
                                                 screen.cand_len))
        return total

    def step_key(self) -> tuple:
        """The base key plus the configured method object: it carries the
        knobs (rho, budget, bands, ...) the arrays alone do not."""
        return super().step_key() + (id(self.impl),)


class _PerQueryBatch:
    """Batch shim over a one-query-at-a-time ``topk(h (d,), k)`` impl."""

    def __init__(self, impl):
        self.impl = impl

    def topk(self, H, k):
        return np.stack([np.asarray(self.impl.topk(H[i], k))
                         for i in range(H.shape[0])])


class ScreenedNumpyHead(BaselineHead):
    """The L2S screen on the paper's own timing protocol: ONE query at a
    time, ragged candidate sets, numpy throughout
    (``core/evaluate.py::PerQueryScreen``) — so its wall clock compares with
    the numpy baselines', per-op overheads identical."""

    def __init__(self, W, b, screen, **kw):
        from repro_torch.core.evaluate import PerQueryScreen
        require_screen(screen, "ScreenedNumpyHead")
        W, b = _host(W), _host(b)
        self.screen = screen
        impl = _PerQueryBatch(PerQueryScreen(W, b, screen))
        super().__init__(impl, W, b, name="screened-cpu", **kw)

    @property
    def flops_per_query(self) -> float:
        return screened_flops_per_query(self.screen, self.W.shape[1])


class SVDHead(BaselineHead):
    """SVD-softmax (Shim et al. 2017): rank-ρ preview + exact rerank."""

    def __init__(self, W, b, rho: int = 16, n_top: int = None, **kw):
        W, b = _host(W), _host(b)
        if n_top is None:
            n_top = max(64, W.shape[0] // 20)
        impl = SVDSoftmax.build(W, b, rho=rho, n_top=n_top)
        super().__init__(impl, W, b, name="svd", **kw)

    @property
    def flops_per_query(self) -> float:
        return float(self.impl.flops_per_query)


class ShortlistHead(BaselineHead):
    """Adaptive-softmax-style frequent shortlist (Grave et al. 2017).

    ``freq_order`` is the frequency-descending word order; it defaults to
    the weight-norm order (a data-free proxy: frequent words grow large
    output embeddings), so the head is constructible from (W, b) alone."""

    def __init__(self, W, b, freq_order=None, n_head: int = None,
                 n_tails: int = 4, descend_rate: float = 0.5, **kw):
        W, b = _host(W), _host(b)
        if freq_order is None:
            freq_order = np.argsort(-np.linalg.norm(W, axis=1))
        if n_head is None:
            n_head = max(1, W.shape[0] // 10)
        impl = AdaptiveShortlist.build(W, b, _host(freq_order),
                                       n_head=n_head, n_tails=n_tails)
        super().__init__(impl, W, b, name="shortlist", **kw)
        self.descend_rate = descend_rate

    @property
    def flops_per_query(self) -> float:
        return float(self.impl.flops_per_query(self.descend_rate))


class GreedyMIPSHead(BaselineHead):
    """Greedy-MIPS (Yu et al. 2017): budgeted per-dimension screening."""

    def __init__(self, W, b, budget: int = 512, **kw):
        W, b = _host(W), _host(b)
        impl = GreedyMIPS.build(W, b, budget=budget)
        super().__init__(impl, W, b, name="greedy-mips", **kw)

    @property
    def flops_per_query(self) -> float:
        return float(self.impl.flops_per_query)


class LSHHead(BaselineHead):
    """LSH-MIPS (Neyshabur & Srebro 2015): SimHash bands over the
    MIPS→NNS-augmented database, exact rerank of bucket candidates."""

    def __init__(self, W, b, bands: int = 8, bits: int = 10, seed: int = 0,
                 **kw):
        W, b = _host(W), _host(b)
        impl = LSHMIPS.build(W, b, bands=bands, bits=bits, seed=seed)
        super().__init__(impl, W, b, name="lsh-mips", **kw)
        self.bands, self.bits = bands, bits

    @property
    def flops_per_query(self) -> float:
        L, d = self.W.shape
        hashing = self.bands * self.bits * (d + 1)
        expected_pool = self.bands * L / max(1, 2 ** self.bits)
        return float(hashing + expected_pool * d)


class PCAHead(BaselineHead):
    """PCA-MIPS (Bachrach et al. 2014): PCA-tree leaf routing + rerank."""

    def __init__(self, W, b, depth: int = 6, **kw):
        W, b = _host(W), _host(b)
        impl = PCAMIPS.build(W, b, depth=depth)
        super().__init__(impl, W, b, name="pca-mips", **kw)
        self.depth = depth

    @property
    def flops_per_query(self) -> float:
        L, d = self.W.shape
        return float(self.depth * (d + 1) + L / max(1, 2 ** self.depth) * d)
