"""Vocab-sharded decode heads: (W, b) row-partitioned into n shards. Twin of
``repro/heads/sharded.py``.

``exact-sharded`` — the exact softmax with the weight matrix split over the
vocabulary: each shard computes logits for its L/n rows, takes a
shard-local top-min(k, L_shard), translates local rows to vocab ids with
its shard offset, and the k·n candidates are gathered shard-major and
re-top-k'd. Each shard's list is sorted descending with ties at the lowest
local index and shard s owns lower ids than shard s + 1, so the merge keeps
the single-device lowest-index tie order: ids equal the ``exact`` head's.

``screened-sharded`` — the paper's L2S head with each cluster's candidate
list split by owning vocab range: ``prepare()`` builds per-shard candidate
tables of LOCAL row ids (sentinel L_shard), in numpy, bit for bit the
reference's. Every query is routed once (``assign_clusters``, a plain
first-index argmax, as the reference routes) and each shard scores only
the candidates it owns; the same local-top-k → gather → re-top-k merge runs
over candidate ids. ``local`` picks the shard-local scoring:

  "torch"  word-granular gather + einsum (the reference's ``"jnp"``);
  "cuda"   the fused kernel (``kernels/fused_topk.py::fused_screened_topk``)
           once per shard over the candidate BLOCKS it owns (the
           reference's ``"pallas"``; needs a 128-word block screen): each
           shard's width is rounded up to a V_BLK multiple so blocks never
           straddle shards, and a shard that owns none of a row's blocks
           takes the kernel's all-sentinel path.

Sampling always takes the word path, on both backends.

One process drives every shard (the reference's single controller over a
``"model"`` mesh): ``prepare()`` places shard s's slab on ``devices[s]`` —
one device may hold several shards, and by default every shard lies on the
weights' device — and each ``shard_map`` body of the reference is a loop
over the shards. The reference's collectives are ``_all_gather`` (a
shard-major concatenation), ``_pmax`` and ``_psum``, on the first shard's
device. The loop is fixed at ``prepare()``, so a CUDA graph records it.
The unsharded W and b are dropped after ``prepare()``: only the slabs stay
resident, and ``memory_bytes`` counts them (total across shards).
``flops_per_query`` and ``bytes_per_query`` are per shard, as the
reference's.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import V_BLK
from repro_torch.core.screening import ScreenParams, assign_clusters
from repro_torch.heads.base import (NEG_INF, ScreenBlockError, SoftmaxHead,
                                    require_screen, sample_from_logits)
from repro_torch.kernels.fused_topk import fused_screened_topk
from repro_torch.kernels.ref import merge_shard_topk, topk_desc
from repro_torch.kernels import cost


# -- merge primitives ---------------------------------------------------------

def simulate_sharded_topk(logits: torch.Tensor, n_shards: int, k: int):
    """Single-tensor model of the sharded pipeline: chunk the vocab axis,
    per-chunk top-min(k, L_shard), offset the ids, concatenate shard-major,
    merge. Equals ``topk_desc(logits, k)`` (ids and values) for every
    (logits, n_shards, k ≤ L). → (ids (B, k) int32, vals (B, k))."""
    B, L = logits.shape
    Ls = -(-L // n_shards)
    lp = torch.cat([logits, logits.new_full((B, n_shards * Ls - L), NEG_INF)],
                   dim=-1)
    kk = min(k, Ls)
    vals, ids = [], []
    for s in range(n_shards):
        v, i = topk_desc(lp[:, s * Ls:(s + 1) * Ls], kk)
        vals.append(v)
        ids.append(i + s * Ls)
    return merge_shard_topk(torch.cat(vals, dim=-1), torch.cat(ids, dim=-1),
                            k, sentinel=L)


# -- the collectives: one tensor per shard, joined on the first shard's device

# Under ``launch/op_cost.count_cost`` each records one collective (its
# result bytes, the reference's convention), even when every shard sits on
# one device and ``.to(lead)`` moves nothing; its plumbing is not counted.

def _all_gather(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """(B, w) per shard → (B, n·w), shard-major (``all_gather(tiled)``)."""
    lead = parts[0].device
    with cost.suspended():
        out = torch.cat([p.to(lead) for p in parts], dim=1)
    cost.record_collective("all-gather", parts, out)
    return out


def _pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    lead = parts[0].device
    with cost.suspended():
        out = torch.stack([p.to(lead) for p in parts]).amax(dim=0)
    cost.record_collective("all-reduce", parts, out)
    return out


def _psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    lead = parts[0].device
    with cost.suspended():
        out = torch.stack([p.to(lead) for p in parts]).sum(dim=0)
    cost.record_collective("all-reduce", parts, out)
    return out


def _global_lse(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Log-sum-exp over the vocab split in ``parts`` (B, w) each: local max
    and sum-exp, joined by ``_pmax`` / ``_psum``. NEG_INF padding adds
    exp(NEG_INF − m) = 0."""
    m = _pmax([p.max(dim=1).values for p in parts])
    s = _psum([torch.exp(p - m.to(p.device)[:, None]).sum(dim=1)
               for p in parts])
    return m + torch.log(s)


def _local_topk_gather(logits: Sequence[torch.Tensor],
                       gids: Sequence[torch.Tensor], k: int, L: int):
    """Each shard's top-min(k, width) over (logits, vocab ids), gathered
    shard-major and re-top-k'd — the one merge every sharded head runs."""
    vals, ids = [], []
    for lg, gi in zip(logits, gids):
        v, pos = topk_desc(lg, min(k, lg.shape[-1]))
        vals.append(v)
        ids.append(torch.gather(gi, -1, pos))
    return merge_shard_topk(_all_gather(vals), _all_gather(ids), k,
                            sentinel=L)


def _combine_shard_logz(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-shard candidate logZ (B,) → log Σ_s exp(lz_s), −∞-safe: a shard
    with no candidates reports −∞ and adds nothing; all shards empty give
    −∞ (probability 0), never NaN."""
    m = _pmax(parts)
    sub = [torch.where(torch.isfinite(m.to(p.device)), p - m.to(p.device),
                       -torch.inf) for p in parts]
    return m + torch.log(_psum([torch.exp(x) for x in sub]))


# -- placement ----------------------------------------------------------------

def shard_devices(n_shards: Optional[int], devices, default: torch.device
                  ) -> Tuple[torch.device, ...]:
    """The device of each shard: ``devices`` as given (n is its length),
    else ``n_shards`` (1 when None) times ``default``."""
    if devices is not None:
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("devices must name at least one device")
        if n_shards is not None and int(n_shards) != len(devices):
            raise ValueError(f"n_shards={n_shards} but {len(devices)} "
                             f"devices were given")
        return devices
    n = 1 if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return (torch.device(default),) * n


class ShardedHead(SoftmaxHead):
    """What the three sharded heads share: the shards' ``devices`` (the
    first one joins the shards' results), ``n_shards`` and a step key that
    names the head's own slabs, its shard count, backend and placement —
    the engine keeps one graph per slab for each."""

    devices: Tuple[torch.device, ...] = ()
    local: Optional[str] = None

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def _slab_tensors(self) -> List[torch.Tensor]:
        """Every tensor the prepared head keeps resident."""
        raise NotImplementedError

    def step_key(self) -> tuple:
        self.prepare()
        return (self.name, type(self), id(self._slab_tensors()[0]),
                self.n_shards, self.local, self.devices)

    @property
    def memory_bytes(self) -> int:
        """Resident bytes of the slabs (and the tables joined on the first
        shard's device), total across shards."""
        self.prepare()
        seen = {id(t): t for t in self._slab_tensors()}
        return sum(int(t.nbytes) for t in seen.values())


def _pad_rows(W: torch.Tensor, b: torch.Tensor, rows: int):
    """(L, d), (L,) → (rows, d), (rows,): zero weight rows and a NEG_INF
    bias past L, which never win a top-k or a draw."""
    L, d = W.shape
    return (torch.cat([W, W.new_zeros((rows - L, d))]),
            torch.cat([b, b.new_full((rows - L,), NEG_INF)]))


# -- exact-sharded ------------------------------------------------------------

class ExactShardedHead(ShardedHead):
    """Exact softmax over a vocab-partitioned (W, b): per-shard local top-k,
    shard-offset ids, a shard-major gather and a global re-top-k."""
    name = "exact-sharded"

    def __init__(self, W: torch.Tensor, b: torch.Tensor,
                 n_shards: Optional[int] = None, devices=None):
        self.W = W
        self.b = b
        self.devices = shard_devices(n_shards, devices, W.device)
        self.L, self.d = (int(x) for x in W.shape)
        self._itemsize = W.element_size()
        self._W = None

    def prepare(self) -> "ExactShardedHead":
        if self._W is not None:
            return self
        n = self.n_shards
        self.Ls = Ls = -(-self.L // n)
        Wp, bp = _pad_rows(self.W, self.b, n * Ls)
        self._W = tuple(Wp[s * Ls:(s + 1) * Ls].to(dev).contiguous()
                        for s, dev in enumerate(self.devices))
        self._b = tuple(bp[s * Ls:(s + 1) * Ls].to(dev).contiguous()
                        for s, dev in enumerate(self.devices))
        self._gids = tuple(torch.arange(s * Ls, (s + 1) * Ls,
                                        dtype=torch.int32, device=dev)
                           for s, dev in enumerate(self.devices))
        del self.W, self.b                 # only the slabs stay resident
        return self

    def _slab_tensors(self):
        return list(self._W) + list(self._b)

    @property
    def slabs(self) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
        """((W_s (Ls, d), b_s (Ls,)), ...) per shard."""
        self.prepare()
        return tuple(zip(self._W, self._b))

    def _logits(self, h) -> List[torch.Tensor]:
        """Each shard's (B, Ls) float32 logits."""
        self.prepare()
        return [(h.to(W.device) @ W.T + b).float()
                for W, b in zip(self._W, self._b)]

    def _gids_for(self, B: int):
        return [g[None].expand(B, -1) for g in self._gids]

    def topk(self, h, k: int):
        return _local_topk_gather(self._logits(h), self._gids_for(h.shape[0]),
                                  k, self.L)

    def topk_logprobs(self, h, k: int):
        logits = self._logits(h)
        z = _global_lse(logits)
        ids, vals = _local_topk_gather(logits, self._gids_for(h.shape[0]), k,
                                       self.L)
        return ids, vals - z[:, None]

    def sample(self, h, temperature: float = 1.0, top_p: float = 1.0,
               generator=None, gumbel=None):
        """The full logits gathered and cut to L: the ``exact`` head's
        draw given the same noise."""
        logits = _all_gather(self._logits(h))[:, :self.L]
        return sample_from_logits(logits, temperature, top_p,
                                  self.noise(h, temperature, generator,
                                             gumbel))

    def noise_shape(self, batch: int, temperature: float):
        return None if temperature <= 0 else (batch, self.L)

    @property
    def flops_per_query(self) -> float:
        """Per-shard MACs: one shard's L/n rows."""
        return float(-(-self.L // self.n_shards) * self.d)

    @property
    def bytes_per_query(self) -> float:
        """Per-shard bytes: the shard's weight rows streamed once and its
        local logit row written back for the local top-k."""
        Ls = -(-self.L // self.n_shards)
        return float((Ls * self.d + 2 * Ls) * self._itemsize)


# -- screened-sharded ---------------------------------------------------------

def _word_tables(cand: np.ndarray, lens: np.ndarray, blk: int, L: int,
                 n: int, Ls: int) -> np.ndarray:
    """(n, r, Cs) int32 per-shard candidate tables: cluster t's words
    (blocks expanded) that shard s owns, as local rows ascending, sentinel
    Ls past the end; Cs is the largest shard's count rounded up to 8."""
    r = cand.shape[0]
    per_cluster = []
    for t in range(r):
        items = cand[t, :lens[t]].astype(np.int64)
        words = items if blk == 1 else \
            (items[:, None] * blk + np.arange(blk)).reshape(-1)
        per_cluster.append(np.sort(words[words < L]))
    counts = [[int(((w >= s * Ls) & (w < (s + 1) * Ls)).sum())
               for w in per_cluster] for s in range(n)]
    Cs = max(1, max(max(c) for c in counts))
    Cs = -(-Cs // 8) * 8
    table = np.full((n, r, Cs), Ls, np.int32)
    for s in range(n):
        for t, w in enumerate(per_cluster):
            local = w[(w >= s * Ls) & (w < (s + 1) * Ls)] - s * Ls
            table[s, t, :len(local)] = local
    return table


def _block_tables(cand: np.ndarray, lens: np.ndarray, n: int, nbs: int
                  ) -> np.ndarray:
    """(n, r, Kb) int32 per-shard candidate BLOCK tables: cluster t's blocks
    that shard s owns (nbs blocks a shard), local ids ascending (the global
    tie order survives the shard-major merge), sentinel nbs."""
    r = cand.shape[0]
    blocks = [np.sort(cand[t, :lens[t]].astype(np.int64)) for t in range(r)]
    kb = max(1, max((int(((g >= s * nbs) & (g < (s + 1) * nbs)).sum())
                     for g in blocks for s in range(n)), default=1))
    table = np.full((n, r, kb), nbs, np.int32)
    for s in range(n):
        for t, g in enumerate(blocks):
            loc = g[(g >= s * nbs) & (g < (s + 1) * nbs)] - s * nbs
            table[s, t, :len(loc)] = loc
    return table


class ScreenedShardedHead(ShardedHead):
    """L2S screening with vocab-partitioned weights AND candidate tables:
    each shard scores only the routed candidates it owns. ``local`` picks
    the shard-local scoring (module docstring)."""
    name = "screened-sharded"

    def __init__(self, W: torch.Tensor, b: torch.Tensor, screen: ScreenParams,
                 n_shards: Optional[int] = None, devices=None,
                 local: str = "torch"):
        require_screen(screen, "ScreenedShardedHead")
        if local not in ("torch", "cuda"):
            raise ValueError(f"local must be 'torch' or 'cuda', got "
                             f"{local!r}")
        if local == "cuda" and screen.block != V_BLK:
            raise ScreenBlockError(
                f"local='cuda' needs a {V_BLK}-word block-candidate screen "
                f"(got block={screen.block}); fit with vocab_block={V_BLK}")
        self.W = W
        self.b = b
        self.screen = screen
        self.local = local
        self.devices = shard_devices(n_shards, devices, W.device)
        self.L, self.d = (int(x) for x in W.shape)
        self._lbar = float(screen.cand_len.double().mean()) * screen.block
        self._W = None

    def prepare(self) -> "ScreenedShardedHead":
        if self._W is not None:
            return self
        n, L = self.n_shards, self.L
        Ls = -(-L // n)
        if self.local == "cuda":
            # blocks never straddle shards, and a shard's rows view as
            # (Ls / V_BLK, V_BLK, d) tiles without a copy
            Ls = -(-Ls // V_BLK) * V_BLK
        self.Ls = Ls
        Wp, bp = _pad_rows(self.W, self.b, n * Ls)
        cand = self.screen.cand_idx.cpu().numpy()
        lens = self.screen.cand_len.cpu().numpy()
        words = _word_tables(cand, lens, self.screen.block, L, n, Ls)
        self.c_shard_max = words.shape[-1]
        devs = self.devices
        self._W = tuple(Wp[s * Ls:(s + 1) * Ls].to(d).contiguous()
                        for s, d in enumerate(devs))
        self._b = tuple(bp[s * Ls:(s + 1) * Ls].to(d).contiguous()
                        for s, d in enumerate(devs))
        self._cand = tuple(torch.from_numpy(words[s]).to(d)
                           for s, d in enumerate(devs))
        self.v = self.screen.v.to(self.lead)   # routing: once, replicated
        self._blocks = None
        if self.local == "cuda":
            blocks = _block_tables(cand, lens, n, Ls // V_BLK)
            self.kb_shard_max = blocks.shape[-1]
            self._blocks = tuple(torch.from_numpy(blocks[s]).to(d)
                                 for s, d in enumerate(devs))
        del self.W, self.b                 # only the slabs stay resident
        return self

    def _slab_tensors(self):
        out = list(self._W) + list(self._b) + list(self._cand) + [self.v]
        return out + list(self._blocks or ())

    @property
    def slabs(self) -> tuple:
        """Per shard: (W_s (Ls, d), b_s (Ls,), word table (r, Cs)) and, for
        ``local="cuda"``, the block table (r, Kb)."""
        self.prepare()
        tabs = (self._cand,) + ((self._blocks,) if self._blocks else ())
        return tuple(zip(self._W, self._b, *tabs))

    def _route(self, h) -> torch.Tensor:
        self.prepare()
        return assign_clusters(self.v, h.to(self.lead)).long()

    def _word_logits(self, h):
        """Each shard's (logits (B, Cs), vocab ids (B, Cs)) over the routed
        candidates it owns: NEG_INF and sentinel L at padding."""
        cluster = self._route(h)
        logits, gids = [], []
        for s, (W, b, cand) in enumerate(zip(self._W, self._b, self._cand)):
            dev = W.device
            items = cand[cluster.to(dev)]
            valid = items < self.Ls
            safe = torch.where(valid, items, 0).long()
            lg = (torch.einsum("bcd,bd->bc", W[safe], h.to(dev)) +
                  b[safe]).float()
            logits.append(torch.where(valid, lg, NEG_INF))
            gids.append(torch.where(valid, items + s * self.Ls, self.L))
        return logits, gids

    def _fused(self, h, k: int):
        """Per shard, the fused kernel over its local blocks → its top
        (vals, vocab ids) and candidate logZ."""
        cluster = self._route(h)
        nbs = self.Ls // V_BLK
        vals, gids, logz = [], [], []
        for s, (W, b, blocks) in enumerate(zip(self._W, self._b,
                                               self._blocks)):
            dev = W.device
            ids = blocks[cluster.to(dev)]
            lids, v, lz = fused_screened_topk(
                W.view(nbs, V_BLK, self.d), b.view(nbs, V_BLK),
                h.to(dev).contiguous(), ids,
                k=min(k, ids.shape[-1] * V_BLK))
            vals.append(v)
            # the kernel's sentinel row is Ls
            gids.append(torch.where(lids < self.Ls, lids + s * self.Ls,
                                    self.L))
            logz.append(lz)
        return vals, gids, logz

    def topk(self, h, k: int):
        if self.local == "cuda":
            vals, gids, _ = self._fused(h, k)
            return merge_shard_topk(_all_gather(vals), _all_gather(gids), k,
                                    sentinel=self.L)
        return _local_topk_gather(*self._word_logits(h), k, self.L)

    def topk_logprobs(self, h, k: int):
        """Log-softmax over the cluster's whole candidate set (paper §4.2),
        assembled from the shards' pieces; an empty candidate union is
        probability 0 (NEG_INF) on both backends."""
        if self.local == "cuda":
            vals, gids, logz = self._fused(h, k)
            z = _combine_shard_logz(logz)
            ids, mvals = merge_shard_topk(_all_gather(vals), _all_gather(gids),
                                          k, sentinel=self.L)
            return ids, torch.where(torch.isfinite(z)[:, None],
                                    mvals - z[:, None], NEG_INF)
        logits, gids = self._word_logits(h)
        z = _global_lse(logits)
        ids, mvals = _local_topk_gather(logits, gids, k, self.L)
        return ids, torch.where((z <= NEG_INF / 2)[:, None], NEG_INF,
                                mvals - z[:, None])

    def sample(self, h, temperature: float = 1.0, top_p: float = 1.0,
               generator=None, gumbel=None):
        """Sample within the routed candidate set (probability 0 elsewhere)
        over the shards' gathered word rows, on both backends; the noise is
        (B, n·Cs)."""
        logits, gids = (_all_gather(x) for x in self._word_logits(h))
        choice = sample_from_logits(logits, temperature, top_p,
                                    self.noise(h, temperature, generator,
                                               gumbel))
        return torch.gather(gids, 1, choice[:, None].long())[:, 0].to(
            torch.int32)

    def noise_shape(self, batch: int, temperature: float):
        self.prepare()
        if temperature <= 0:
            return None
        return (batch, self.n_shards * self.c_shard_max)

    @property
    def flops_per_query(self) -> float:
        """Per-shard MACs: routing on every shard (r·d), the mean candidate
        matmul split 1/n."""
        return float((self.screen.r + self._lbar / self.n_shards) * self.d)

    @property
    def bytes_per_query(self) -> float:
        """Per-shard bytes (as ``flops_per_query``) plus the write-back: the
        (Cs) candidate-logit row for ``"torch"``, only O(V_BLK) kernel
        results for ``"cuda"``."""
        if self.local == "cuda":
            writeback = float(V_BLK)
        else:
            writeback = float(getattr(self, "c_shard_max",
                                      self.screen.c_max * self.screen.block))
        return float(((self.screen.r + self._lbar / self.n_shards) * self.d +
                      2 * writeback) * 4)
