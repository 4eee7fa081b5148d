"""AdaptiveHead — frequency-tiered adaptive softmax (Grave et al.) on the
port's kernels. Twin of the single-device part of
``repro/heads/adaptive.py`` (``adaptive-sharded`` is ROADMAP.md Queue 1
item 10).

The vocabulary is split by unigram frequency into a SHORT-LIST tier (the
top-F words, packed into V_BLK tiles and scored for every query) plus C
rare-TAIL clusters, each represented in the short-list competition by one
gate vector (the mean tail weight and bias). A query descends into its
argmax tail cluster only when the best gate logit beats the k-th short-list
logit, so Zipfian traffic pays O((F + C)·d) almost always and the tail
matmul in expectation (``tiered_flops_per_query``). ``shortlist=L`` (no
tails) is the exact head over a frequency-permuted vocabulary.

Fused path (default): two launches of the fused kernel a step through
``kernels/ops.py::tier_fused_topk`` — the short tier with its nb0 block ids
broadcast over the rows, the tail tier with K = kb block ids per row and
those of a non-descending row masked to the sentinel, so that row takes the
kernel's all-sentinel path (NEG_INF vals, sentinel ids, logZ = −∞). The
tiers merge by (value desc, position asc) (``merge_shard_topk``) and their
logZ recombine −∞-safely (``combine_tier_logz``). The gate is a plain
``h @ gᵀ + gb`` and a first-index argmax, as in the reference (no route
kernel).

``fused=False`` and sampling build word-granular candidate rows through the
gather kernel (``kernels/screen.py::screened_logits``) over the same block
ids, so on the card fused and unfused ids and values are bit-identical, as
``screened-cuda``'s are. On CPU tensors both kernel wrappers run their plain
PyTorch versions. Every call is capturable into a CUDA graph.
"""
from __future__ import annotations

import hashlib
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.configs.base import V_BLK
from repro_torch.heads.base import (NEG_INF, SoftmaxHead, sample_from_logits,
                                    tiered_bytes_per_query,
                                    tiered_flops_per_query)
from repro_torch.heads.sharded import merge_shard_topk
from repro_torch.kernels.ops import tier_fused_topk
from repro_torch.kernels.ref import topk_desc
from repro_torch.kernels.screen import screened_logits


# -- tier layout (numpy, the reference's bit for bit) -----------------------

def _build_tiers(W, b, counts, shortlist, n_tails):
    """Frequency-tiered packed layout.

    Words sort by descending unigram count (stable — ties keep vocab order;
    weight-row norm when ``counts`` is None). The top-F words form the
    short-list tier; the remainder splits into ≤ n_tails contiguous-by-rank
    tail clusters. Each tier pads independently to a V_BLK multiple with
    zero-weight / NEG_INF-bias rows, so packed blocks never straddle tiers.

    Returns the packed tiles, the packed-row → vocab-id map (sentinel row =
    L), the tail block table, the tail gate vectors (mean tail weight and
    bias), and the unigram-weighted cost-model statistics (``p_descend`` =
    unigram mass beyond the short-list, ``exp_tail_words`` = unigram-
    weighted mean tail-cluster width)."""
    W = np.asarray(W, np.float32)
    b = np.asarray(b, np.float32)
    L, d = W.shape
    if counts is not None:
        c = np.asarray(counts, np.float64).reshape(-1)
        if c.shape[0] != L:
            raise ValueError(f"counts has {c.shape[0]} entries for a "
                             f"{L}-word vocabulary")
        order = np.argsort(-c, kind="stable")
        mass = c[order]
        unigram = mass / mass.sum() if mass.sum() > 0 else None
    else:
        order = np.argsort(-np.linalg.norm(W, axis=1), kind="stable")
        unigram = None
    if unigram is None:
        # deterministic fallback: Zipf(1) over frequency rank
        z = 1.0 / np.arange(1, L + 1, dtype=np.float64)
        unigram = z / z.sum()

    F = L if shortlist is None else int(shortlist)
    F = max(1, min(L, F))
    tails = [t for t in np.array_split(order[F:], max(1, int(n_tails)))
             if len(t)]
    tiers = [order[:F]] + tails

    rows_w, rows_b, rows_g, tier_nb = [], [], [], []
    for words in tiers:
        nbt = -(-len(words) // V_BLK)
        padn = nbt * V_BLK - len(words)
        rows_w.append(np.pad(W[words], ((0, padn), (0, 0))))
        rows_b.append(np.pad(b[words], (0, padn), constant_values=NEG_INF))
        rows_g.append(np.pad(words.astype(np.int64), (0, padn),
                             constant_values=L))
        tier_nb.append(nbt)
    packed_w = np.concatenate(rows_w, axis=0)
    n_blk = packed_w.shape[0] // V_BLK
    Wblk = packed_w.reshape(n_blk, V_BLK, d)
    bblk = np.concatenate(rows_b).reshape(n_blk, V_BLK)
    # +1: the fused kernel's all-sentinel id n_blk·V_BLK maps to vocab L
    gid = np.append(np.concatenate(rows_g), L).astype(np.int32)

    nb0, C = tier_nb[0], len(tails)
    tail_tab = g = gb = None
    if C:
        kb = max(tier_nb[1:])
        tail_tab = np.full((C, kb), n_blk, np.int32)
        off = nb0
        for ci, nbt in enumerate(tier_nb[1:]):
            tail_tab[ci, :nbt] = np.arange(off, off + nbt)
            off += nbt
        g = np.stack([W[t].mean(axis=0) for t in tails]).astype(np.float32)
        gb = np.asarray([b[t].mean() for t in tails], np.float32)

    # cost-model statistics over the unigram (in RANK space: unigram[i] is
    # the mass of the i-th most frequent word)
    p_descend = float(unigram[F:].sum()) if C else 0.0
    if C and p_descend > 0:
        off, exp_tail = F, 0.0
        for t in tails:
            exp_tail += unigram[off:off + len(t)].sum() / p_descend * len(t)
            off += len(t)
        exp_tail_words = float(exp_tail)
    elif C:
        exp_tail_words = float(np.mean([len(t) for t in tails]))
    else:
        exp_tail_words = 0.0

    return SimpleNamespace(order=order, F=F, C=C, nb0=nb0, n_blk=n_blk,
                           kb=0 if not C else tail_tab.shape[1],
                           Wblk=Wblk, bblk=bblk, gid=gid, tail_tab=tail_tab,
                           g=g, gb=gb, tail_sizes=[len(t) for t in tails],
                           p_descend=p_descend,
                           exp_tail_words=exp_tail_words)


# -- −inf-safe cross-tier recombination --------------------------------------

def combine_tier_logz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise log(eᵃ + eᵇ), the cross-tier §4.2 logZ: a tier that
    scored no candidates (a non-descending query's tail) reports −∞ and
    contributes nothing; both tiers empty give −∞, never NaN."""
    m = torch.maximum(a, b)
    safe = torch.isfinite(m)
    m0 = torch.where(safe, m, 0.0)
    s = torch.exp(a - m0) + torch.exp(b - m0)
    return torch.where(safe, m0 + torch.log(s), -torch.inf)


def _masked_lse(logits: torch.Tensor) -> torch.Tensor:
    """Row log-sum-exp treating ≤ NEG_INF/2 entries as absent — the
    unfused twin of the fused kernel's logZ: an all-masked row gives −∞,
    never NaN."""
    m = logits.max(dim=-1).values
    live = m > NEG_INF / 2
    m0 = torch.where(live, m, 0.0)
    s = torch.where(logits > NEG_INF / 2, torch.exp(logits - m0[:, None]),
                    0.0).sum(dim=-1)
    return torch.where(live, m0 + torch.log(s), -torch.inf)


# -- adaptive (single-device) ------------------------------------------------

class AdaptiveHead(SoftmaxHead):
    """Frequency-tiered adaptive softmax over packed V_BLK tiles; see the
    module docstring. ``fused=True`` (default) reduces each tier through the
    fused kernel; ``fused=False`` builds the word-granular rows through the
    gather kernel, with identical ids and tie order."""
    name = "adaptive"
    _MEMORY_ATTRS = ("W", "b", "_Wb", "_bb", "_gid", "_short_blocks",
                     "_tail_tab", "_g", "_gb")

    def __init__(self, W: torch.Tensor, b: torch.Tensor, counts=None,
                 shortlist=None, n_tails: int = 4, fused: bool = True):
        if n_tails < 1:
            raise ValueError(f"n_tails must be >= 1, got {n_tails}")
        self.W = W
        self.b = b
        self.counts = (None if counts is None else
                       np.asarray(torch.as_tensor(counts).cpu()))
        self._counts_digest = (None if counts is None else hashlib.sha1(
            np.ascontiguousarray(self.counts, np.float64).tobytes()
        ).hexdigest())
        self.shortlist = shortlist
        self.n_tails = int(n_tails)
        self.fused = bool(fused)
        self._Wb = None

    def prepare(self) -> "AdaptiveHead":
        if self._Wb is not None:
            return self
        lay = _build_tiers(self.W.detach().cpu().numpy(),
                           self.b.detach().cpu().numpy(), self.counts,
                           self.shortlist, self.n_tails)
        dev = self.W.device

        def put(a):
            return None if a is None else torch.from_numpy(a).to(dev)
        self._lay = lay
        self.L = int(self.W.shape[0])
        self._Wb = put(np.ascontiguousarray(lay.Wblk))
        self._bb = put(lay.bblk)
        self._gid = put(lay.gid)
        self._short_blocks = torch.arange(lay.nb0, dtype=torch.int32,
                                          device=dev)
        self._tail_tab, self._g, self._gb = (put(lay.tail_tab), put(lay.g),
                                             put(lay.gb))
        return self

    # -- tier bodies ---------------------------------------------------------
    def _short_ids(self, B: int) -> torch.Tensor:
        """The short tier's block ids broadcast over the rows (B, nb0)."""
        return self._short_blocks[None].expand(B, -1).contiguous()

    def _gate(self, h):
        """Gate logits (B, C), the argmax tail cluster (first index)."""
        gate = (h @ self._g.T + self._gb[None]).float()
        return gate, torch.argmax(gate, dim=-1)

    def _tail_ids(self, cluster, descend) -> torch.Tensor:
        """Each row's argmax tail cluster's blocks (B, kb) int32, the
        sentinel n_blk at non-descending rows."""
        n_blk = self._Wb.shape[0]
        return torch.where(descend[:, None], self._tail_tab[cluster.long()],
                           n_blk).to(torch.int32).contiguous()

    def _rows(self, h, block_ids):
        """Word-granular candidate row over ``block_ids`` through the gather
        kernel: logits (B, K·V_BLK), NEG_INF at sentinel slots, and vocab
        ids (B, K·V_BLK), L at sentinel slots and pad rows."""
        n_blk = self._Wb.shape[0]
        B = h.shape[0]
        raw = screened_logits(self._Wb, self._bb, h, block_ids)
        valid = ((block_ids >= 0) & (block_ids < n_blk))[..., None]
        lane = torch.arange(V_BLK, dtype=torch.int32, device=h.device)
        rows = torch.where(valid, block_ids[..., None] * V_BLK + lane,
                           n_blk * V_BLK)
        return (torch.where(valid, raw, NEG_INF).reshape(B, -1),
                self._gid[rows.long()].reshape(B, -1))

    @staticmethod
    def _descend(gate, svals, ks: int, k: int):
        """Descend iff the best tail gate beats the k-th short-list logit;
        when k exceeds the short-list capacity every query descends."""
        if ks < k:
            return torch.ones(gate.shape[:1], dtype=torch.bool,
                              device=gate.device)
        return gate.max(dim=-1).values >= svals[:, -1]

    def _tail_blocks(self, h, svals, ks: int, k: int):
        """The tail tier's block ids (B, kb) by the descent rule, given the
        short tier's top ``ks`` values → (block ids, descend (B,) bool)."""
        gate, cluster = self._gate(h)
        descend = self._descend(gate, svals, ks, k)
        return self._tail_ids(cluster, descend), descend

    def tier_blocks(self, h, k: int):
        """The block ids the two tiers of ``topk(h, k)`` read → (short
        (B, nb0), tail (B, kb) or None without tails, descend (B,) bool):
        the short tier's k-th value from its fused launch, then the head's
        own descent rule."""
        self.prepare()
        h = h.contiguous()
        B = h.shape[0]
        short = self._short_ids(B)
        if self._tail_tab is None:
            return short, None, torch.zeros(B, dtype=torch.bool,
                                            device=h.device)
        ks = min(k, self._lay.nb0 * V_BLK)
        _, svals, _ = tier_fused_topk(self._Wb, self._bb, h, short, k=ks)
        return (short,) + self._tail_blocks(h, svals, ks, k)

    @property
    def layout(self) -> SimpleNamespace:
        """The tier layout of ``_build_tiers`` (sizes, block tables)."""
        return self.prepare()._lay

    def _fused(self, h, k: int):
        B = h.shape[0]
        ks = min(k, self._lay.nb0 * V_BLK)
        srows, svals, slogz = tier_fused_topk(self._Wb, self._bb, h,
                                              self._short_ids(B), k=ks)
        sgids = self._gid[srows.long()]
        if self._tail_tab is None:
            ids, vals = merge_shard_topk(svals, sgids, k, sentinel=self.L)
            return ids, vals, slogz
        tb, _ = self._tail_blocks(h, svals, ks, k)
        kt = min(k, self._lay.kb * V_BLK)
        trows, tvals, tlogz = tier_fused_topk(self._Wb, self._bb, h, tb, k=kt)
        ids, vals = merge_shard_topk(
            torch.cat([svals, tvals], dim=-1),
            torch.cat([sgids, self._gid[trows.long()]], dim=-1), k,
            sentinel=self.L)
        return ids, vals, combine_tier_logz(slogz, tlogz)

    def _unfused(self, h, k: int):
        slog, sids = self._rows(h, self._short_ids(h.shape[0]))
        ks = min(k, slog.shape[-1])
        svals, pos = topk_desc(slog, ks)
        sgids = torch.gather(sids, -1, pos)
        if self._tail_tab is None:
            ids, vals = merge_shard_topk(svals, sgids, k, sentinel=self.L)
            return ids, vals, _masked_lse(slog)
        tlog, tids = self._rows(h, self._tail_blocks(h, svals, ks, k)[0])
        kt = min(k, tlog.shape[-1])
        tvals, tpos = topk_desc(tlog, kt)
        ids, vals = merge_shard_topk(
            torch.cat([svals, tvals], dim=-1),
            torch.cat([sgids, torch.gather(tids, -1, tpos)], dim=-1), k,
            sentinel=self.L)
        return ids, vals, combine_tier_logz(_masked_lse(slog),
                                            _masked_lse(tlog))

    def _run(self, h, k: int):
        self.prepare()
        h = h.contiguous()
        return self._fused(h, k) if self.fused else self._unfused(h, k)

    # -- queries ---------------------------------------------------------------
    def topk(self, h, k: int):
        ids, vals, _ = self._run(h, k)
        return ids, vals

    def topk_logprobs(self, h, k: int):
        """Log-softmax over the tiers the query scored (short-list ∪
        descended tail), probability 0 elsewhere — the paper's §4.2
        convention with the tier union as the candidate space."""
        ids, vals, logz = self._run(h, k)
        lp = torch.where(torch.isfinite(logz)[:, None], vals - logz[:, None],
                         NEG_INF)
        return ids, torch.where(vals <= NEG_INF / 2, NEG_INF, lp)

    def _sample_row(self, h):
        """Word-granular row across both tiers (sampling needs the whole
        distribution), descending by the k = 1 gate rule: iff the best gate
        beats the best short-list logit, as greedy decode does."""
        slog, sids = self._rows(h, self._short_ids(h.shape[0]))
        if self._tail_tab is None:
            return slog, sids
        gate, cluster = self._gate(h)
        descend = gate.max(dim=-1).values >= slog.max(dim=-1).values
        tlog, tids = self._rows(h, self._tail_ids(cluster, descend))
        return torch.cat([slog, tlog], dim=-1), torch.cat([sids, tids], dim=-1)

    def sample(self, h, temperature: float = 1.0, top_p: float = 1.0,
               generator=None, gumbel=None):
        """Temperature / nucleus sample over the scored tiers; the noise is
        (B, (nb0 + kb)·V_BLK) standard Gumbel noise, one per row slot."""
        self.prepare()
        h = h.contiguous()
        logits, gids = self._sample_row(h)
        choice = sample_from_logits(logits, temperature, top_p,
                                    self.noise(h, temperature, generator,
                                               gumbel))
        return torch.gather(gids, 1, choice[:, None].long())[:, 0].to(
            torch.int32)

    def noise_shape(self, batch: int, temperature: float):
        self.prepare()
        if temperature <= 0:
            return None
        return (batch, (self._lay.nb0 + self._lay.kb) * V_BLK)

    # -- metadata --------------------------------------------------------------
    def step_key(self) -> tuple:
        """The base key plus what shapes the tiers: the short-list size, the
        number of tails and a digest of the counts."""
        return super().step_key() + (self.shortlist, self.n_tails,
                                     self._counts_digest)

    @property
    def flops_per_query(self) -> float:
        self.prepare()
        lay = self._lay
        return tiered_flops_per_query(lay.F, lay.C, lay.p_descend,
                                      lay.exp_tail_words, int(self.W.shape[1]))

    @property
    def bytes_per_query(self) -> float:
        self.prepare()
        lay = self._lay
        if self.fused:
            writeback = 2.0 * V_BLK          # O(k) + logZ per tier kernel
        else:
            writeback = float((lay.nb0 + lay.kb) * V_BLK)
        return tiered_bytes_per_query(lay.F, lay.C, lay.p_descend,
                                      lay.exp_tail_words, int(self.W.shape[1]),
                                      writeback_floats=writeback)

    @property
    def memory_bytes(self) -> int:
        self.prepare()
        return SoftmaxHead.memory_bytes.fget(self)
