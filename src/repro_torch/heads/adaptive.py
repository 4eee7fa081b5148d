"""AdaptiveHead and AdaptiveShardedHead — frequency-tiered adaptive softmax
(Grave et al.) on the port's kernels. Twin of ``repro/heads/adaptive.py``.

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

``adaptive-sharded`` keeps the short tier, the gates and the descent rule
replicated (held once, on the first shard's device) and splits the packed
tail region by vocab range into n shards of a V_BLK multiple each
(``heads/sharded.py`` for the placement and the collectives): each shard
runs one fused launch over the tail blocks it owns of each row's cluster
(a non-descending row, or a shard owning none of the cluster, takes the
all-sentinel path), its packed rows map to vocab ids through the tail id
map, and the shards' lists merge shard-major before the cross-tier merge.
Ids equal the ``adaptive`` head's.
"""
from __future__ import annotations

import hashlib
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import V_BLK
from repro_torch.heads.base import (NEG_INF, SoftmaxHead, sample_from_logits,
                                    tiered_bytes_per_query,
                                    tiered_flops_per_query)
from repro_torch.heads.sharded import (ShardedHead, _all_gather,
                                       _combine_shard_logz, merge_shard_topk,
                                       shard_devices)
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


# -- gate, descent and rows (both heads) --------------------------------------

def _gate(g: torch.Tensor, gb: torch.Tensor, h: torch.Tensor):
    """Gate logits (B, C) and the argmax tail cluster (first index)."""
    gate = (h @ g.T + gb[None]).float()
    return gate, torch.argmax(gate, dim=-1)


def _descend_mask(gate, svals, ks: int, k: int) -> torch.Tensor:
    """Descend iff the best tail gate beats the k-th short-list logit; when
    k exceeds the short-list capacity every query descends."""
    if ks < k:
        return torch.ones(gate.shape[:1], dtype=torch.bool,
                          device=gate.device)
    return gate.max(dim=-1).values >= svals[:, -1]


def _short_ids(short_blocks: torch.Tensor, B: int) -> torch.Tensor:
    """The short tier's block ids broadcast over the rows (B, nb0)."""
    return short_blocks[None].expand(B, -1).contiguous()


def _tier_rows(Wb, bb, h, block_ids):
    """Word-granular candidate row over ``block_ids`` through the gather
    kernel → (logits (B, K·V_BLK), NEG_INF at sentinel slots; packed rows
    (B, K·V_BLK) int32, n_blk·V_BLK at sentinel slots)."""
    n_blk = Wb.shape[0]
    B = h.shape[0]
    raw = screened_logits(Wb, bb, h, block_ids)
    valid = ((block_ids >= 0) & (block_ids < n_blk))[..., None]
    lane = torch.arange(V_BLK, dtype=torch.int32, device=h.device)
    rows = torch.where(valid, block_ids[..., None] * V_BLK + lane,
                       n_blk * V_BLK)
    return (torch.where(valid, raw, NEG_INF).reshape(B, -1),
            rows.reshape(B, -1))


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
        lay = _build_tiers(self.W.detach().float().cpu().numpy(),
                           self.b.detach().float().cpu().numpy(), self.counts,
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
        logits, rows = _tier_rows(self._Wb, self._bb, h, block_ids)
        return logits, self._gid[rows.long()]

    def _tail_blocks(self, h, svals, ks: int, k: int):
        """The tail tier's block ids (B, kb) by the descent rule, given the
        short tier's top ``ks`` values → (block ids, descend (B,) bool)."""
        gate, cluster = _gate(self._g, self._gb, h)
        descend = _descend_mask(gate, svals, ks, k)
        return self._tail_ids(cluster, descend), descend

    def tier_blocks(self, h, k: int):
        """The block ids the two tiers of ``topk(h, k)`` read → (short
        (B, nb0), tail (B, kb) or None without tails, descend (B,) bool):
        the short tier's k-th value from its fused launch, then the head's
        own descent rule."""
        self.prepare()
        h = h.float().contiguous()
        B = h.shape[0]
        short = _short_ids(self._short_blocks, B)
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
        srows, svals, slogz = tier_fused_topk(
            self._Wb, self._bb, h, _short_ids(self._short_blocks, B), k=ks)
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
        slog, sids = self._rows(h, _short_ids(self._short_blocks, h.shape[0]))
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
        h = h.float().contiguous()
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
        slog, sids = self._rows(h, _short_ids(self._short_blocks, h.shape[0]))
        if self._tail_tab is None:
            return slog, sids
        gate, cluster = _gate(self._g, self._gb, h)
        descend = gate.max(dim=-1).values >= slog.max(dim=-1).values
        tlog, tids = self._rows(h, self._tail_ids(cluster, descend))
        return torch.cat([slog, tlog], dim=-1), torch.cat([sids, tids], dim=-1)

    def sample(self, h, temperature: float = 1.0, top_p: float = 1.0,
               generator=None, gumbel=None):
        """Temperature / nucleus sample over the scored tiers; the noise is
        (B, (nb0 + kb)·V_BLK) standard Gumbel noise, one per row slot."""
        self.prepare()
        h = h.float().contiguous()
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


# -- adaptive-sharded --------------------------------------------------------

class AdaptiveShardedHead(ShardedHead):
    """Adaptive softmax with the rare-tail region split by vocab range over
    n shards and the short-list tier replicated: the tiles almost every
    query reads stay whole, the tiles almost no query reads split 1/n.
    Ids equal the ``adaptive`` head's."""
    name = "adaptive-sharded"

    def __init__(self, W: torch.Tensor, b: torch.Tensor, counts=None,
                 shortlist=None, n_tails: int = 4,
                 n_shards: Optional[int] = None, devices=None):
        if n_tails < 1:
            raise ValueError(f"n_tails must be >= 1, got {n_tails}")
        self.W = W
        self.b = b
        self.counts = (None if counts is None else
                       np.asarray(torch.as_tensor(counts).cpu()))
        self.shortlist = shortlist
        self.n_tails = int(n_tails)
        self.devices = shard_devices(n_shards, devices, W.device)
        self.L, self.d = (int(x) for x in W.shape)
        self._lay = None

    def prepare(self) -> "AdaptiveShardedHead":
        if self._lay is not None:
            return self
        n, L, d = self.n_shards, self.L, self.d
        lay = _build_tiers(self.W.detach().float().cpu().numpy(),
                           self.b.detach().float().cpu().numpy(), self.counts,
                           self.shortlist, self.n_tails)

        def put(a, dev=self.lead):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        # the replicated short tier, held once: its packed tiles and an id
        # map whose last entry takes the kernel's sentinel row to L
        self._Wb = put(lay.Wblk[:lay.nb0])
        self._bb = put(lay.bblk[:lay.nb0])
        self._gid_s = put(np.append(lay.gid[:lay.nb0 * V_BLK], L)
                          .astype(np.int32))
        self._short_blocks = torch.arange(lay.nb0, dtype=torch.int32,
                                          device=self.lead)
        self._Wt = self._bt = self._btab = ()
        self._g = self._gb = self._gid_t = None
        if lay.C:
            # the tail region: packed rows after the short tier, padded so
            # that each shard owns a V_BLK multiple (blocks never straddle)
            tail_rows = (lay.n_blk - lay.nb0) * V_BLK
            self.Ls_t = Ls_t = -(-tail_rows // (n * V_BLK)) * V_BLK
            padn = n * Ls_t - tail_rows
            nbs = Ls_t // V_BLK
            Wt = np.pad(lay.Wblk[lay.nb0:].reshape(tail_rows, d),
                        ((0, padn), (0, 0))).reshape(n, nbs, V_BLK, d)
            bt = np.pad(lay.bblk[lay.nb0:].reshape(tail_rows), (0, padn),
                        constant_values=NEG_INF).reshape(n, nbs, V_BLK)
            # tail packed row → vocab id, L past the vocabulary
            gid_t = np.pad(lay.gid[lay.nb0 * V_BLK: lay.n_blk * V_BLK],
                           (0, padn), constant_values=L)
            # cluster c's blocks in tail-region coordinates, split by
            # owning shard, local ids ascending, sentinel nbs
            region = [lay.tail_tab[c][lay.tail_tab[c] < lay.n_blk] - lay.nb0
                      for c in range(lay.C)]
            kb = max(1, max((int(((g >= s * nbs) & (g < (s + 1) * nbs)).sum())
                             for g in region for s in range(n)), default=1))
            btab = np.full((n, lay.C, kb), nbs, np.int32)
            for s in range(n):
                for c, g in enumerate(region):
                    loc = g[(g >= s * nbs) & (g < (s + 1) * nbs)] - s * nbs
                    btab[s, c, :len(loc)] = loc
            devs = list(enumerate(self.devices))
            self._Wt = tuple(put(Wt[s], dv) for s, dv in devs)
            self._bt = tuple(put(bt[s], dv) for s, dv in devs)
            self._btab = tuple(put(btab[s], dv) for s, dv in devs)
            self._gid_t = put(gid_t.astype(np.int32))
            self._g, self._gb = put(lay.g), put(lay.gb)
        self._lay = lay
        del self.W, self.b                 # only the placed copies stay
        return self

    @property
    def layout(self) -> SimpleNamespace:
        """The tier layout of ``_build_tiers`` (sizes, block tables)."""
        return self.prepare()._lay

    def _replicated(self) -> List[torch.Tensor]:
        return [t for t in (self._Wb, self._bb, self._gid_s,
                            self._short_blocks, self._g, self._gb,
                            self._gid_t) if t is not None]

    def _slab_tensors(self):
        return (self._replicated() + list(self._Wt) + list(self._bt) +
                list(self._btab))

    @property
    def memory_bytes(self) -> int:
        """Resident tables, total across shards: the replicated ones (short
        tier, gates, id maps) once PER SHARD, as the reference counts them
        (the footprint a per-device budget divides by n), though one device
        holds them once here; the tail slabs once."""
        self.prepare()
        repl = sum(int(t.nbytes) for t in self._replicated())
        return self.n_shards * repl + sum(
            int(t.nbytes) for t in self._Wt + self._bt + self._btab)

    # -- tiers ----------------------------------------------------------------
    def _tail_gids(self, s: int, rows: torch.Tensor) -> torch.Tensor:
        """Shard ``s``'s packed tail rows (its sentinel Ls_t) → vocab ids,
        on the first shard's device."""
        rows = rows.to(self.lead)
        live = rows < self.Ls_t
        return torch.where(live, self._gid_t[torch.where(
            live, rows + s * self.Ls_t, 0).long()], self.L)

    def _shard_blocks(self, s: int, cluster, descend) -> torch.Tensor:
        """Shard ``s``'s tail block ids (B, kb): each row's cluster's blocks
        it owns, its sentinel at non-descending rows."""
        btab = self._btab[s]
        dev = btab.device
        return torch.where(descend.to(dev)[:, None], btab[cluster.to(dev)],
                           self.Ls_t // V_BLK).to(torch.int32).contiguous()

    def _run(self, h, k: int):
        self.prepare()
        h = h.float().contiguous()
        B, L = h.shape[0], self.L
        ks = min(k, self._lay.nb0 * V_BLK)
        srows, svals, slogz = tier_fused_topk(
            self._Wb, self._bb, h, _short_ids(self._short_blocks, B), k=ks)
        sgids = self._gid_s[srows.long()]
        if not self._Wt:
            ids, vals = merge_shard_topk(svals, sgids, k, sentinel=L)
            return ids, vals, slogz
        gate, cluster = _gate(self._g, self._gb, h)
        descend = _descend_mask(gate, svals, ks, k)
        tvals, tgids, tlogz = [], [], []
        for s, (Wt, bt) in enumerate(zip(self._Wt, self._bt)):
            tb = self._shard_blocks(s, cluster.long(), descend)
            rows, v, lz = tier_fused_topk(Wt, bt, h.to(Wt.device), tb,
                                          k=min(k, tb.shape[-1] * V_BLK))
            tvals.append(v)
            tgids.append(self._tail_gids(s, rows))
            tlogz.append(lz)
        tids, tv = merge_shard_topk(_all_gather(tvals), _all_gather(tgids), k,
                                    sentinel=L)
        ids, vals = merge_shard_topk(torch.cat([svals, tv], dim=-1),
                                     torch.cat([sgids, tids], dim=-1), k,
                                     sentinel=L)
        return ids, vals, combine_tier_logz(slogz, _combine_shard_logz(tlogz))

    # -- queries --------------------------------------------------------------
    def topk(self, h, k: int):
        ids, vals, _ = self._run(h, k)
        return ids, vals

    def topk_logprobs(self, h, k: int):
        """Log-softmax over the tiers the query scored, probability 0
        elsewhere, as the ``adaptive`` head's."""
        ids, vals, logz = self._run(h, k)
        lp = torch.where(torch.isfinite(logz)[:, None], vals - logz[:, None],
                         NEG_INF)
        return ids, torch.where(vals <= NEG_INF / 2, NEG_INF, lp)

    def sample(self, h, temperature: float = 1.0, top_p: float = 1.0,
               generator=None, gumbel=None):
        """Temperature / nucleus sample over the word-granular rows of the
        scored tiers (the short tier, then each shard's part of the tail,
        by the k = 1 gate rule, as ``adaptive`` samples); the noise is
        (B, (nb0 + n·kb)·V_BLK)."""
        self.prepare()
        h = h.float().contiguous()
        slog, srows = _tier_rows(self._Wb, self._bb, h,
                                 _short_ids(self._short_blocks, h.shape[0]))
        logits, gids = [slog], [self._gid_s[srows.long()]]
        if self._Wt:
            gate, cluster = _gate(self._g, self._gb, h)
            descend = gate.max(dim=-1).values >= slog.max(dim=-1).values
            tlog, tgids = [], []
            for s, (Wt, bt) in enumerate(zip(self._Wt, self._bt)):
                lg, rows = _tier_rows(Wt, bt, h.to(Wt.device),
                                      self._shard_blocks(s, cluster.long(),
                                                         descend))
                tlog.append(lg)
                tgids.append(self._tail_gids(s, rows))
            logits.append(_all_gather(tlog))
            gids.append(_all_gather(tgids))
        logits, gids = torch.cat(logits, dim=-1), torch.cat(gids, dim=-1)
        choice = sample_from_logits(logits, temperature, top_p,
                                    self.noise(h, temperature, generator,
                                               gumbel))
        return torch.gather(gids, 1, choice[:, None].long())[:, 0].to(
            torch.int32)

    def noise_shape(self, batch: int, temperature: float):
        self.prepare()
        if temperature <= 0:
            return None
        kb = self._btab[0].shape[-1] if self._btab else 0
        return (batch, (self._lay.nb0 + self.n_shards * kb) * V_BLK)

    # -- metadata -------------------------------------------------------------
    @property
    def flops_per_query(self) -> float:
        """Per-shard MACs: the short tier and the gates on every shard, the
        expected tail matmul split 1/n."""
        lay = self.layout
        return tiered_flops_per_query(lay.F, lay.C, lay.p_descend,
                                      lay.exp_tail_words / self.n_shards,
                                      self.d)

    @property
    def bytes_per_query(self) -> float:
        """Per-shard bytes: the short tiles and gates, this shard's
        expected tail slice, and the two fused launches' O(k) results."""
        lay = self.layout
        return tiered_bytes_per_query(lay.F, lay.C, lay.p_descend,
                                      lay.exp_tail_words / self.n_shards,
                                      self.d, writeback_floats=2.0 * V_BLK)
