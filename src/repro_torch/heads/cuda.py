"""ScreenedCudaHead — the L2S head on the hand-written CUDA kernels.

Twin of ``repro/heads/pallas.py``. Default (``fused=True``): the
``cluster_route`` kernel → the fused subset softmax + top-k kernel
(``kernels/fused_topk.py``). Each query row's candidate logits are reduced on
chip, so device memory sees only (B, k) ids/vals and (B,) logZ instead of the
(B, K·V_BLK) candidate-logit tile. Top-k ids/vals are bit-identical to the
unfused path. The routes go to the kernel with the ids: below
``GROUPED_MIN_ROWS`` = 128 rows it runs a block per (row, slot, part of a
tile); from there (a translation batch, a wide scheduler step) the grouped
grid, where the rows' (row, slot) pairs are grouped by tile through their
clusters and each tile part is loaded once for up to 16 pairs. Same bits.
Sampling uses the same kernel with temperature-scaled Gumbel noise
(Gumbel-max ≡ categorical); nucleus sampling (top_p < 1) needs the whole
candidate distribution and takes the unfused path.

``fused=False`` is the escape hatch: the ``screened_logits`` gather-matmul
kernel → (B, K·V_BLK) logits in device memory → masking + stable top-k in
torch, kept for A/B timing and as a fallback while bringing the fused kernel
up on new hardware.

The head needs a block-candidate screen (``block == V_BLK`` = 128) so a
candidate set is a set of vocab tiles; another block size raises
``ScreenBlockError``. ``prepare()`` packs (W, b) once into
(n_blk, V_BLK, d) tiles; rows past the vocab get a NEG_INF bias. On CPU
tensors every kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import V_BLK
from repro_torch.core.screening import ScreenParams
from repro_torch.heads.base import (NEG_INF, ScreenBlockError, SoftmaxHead,
                                    require_screen, sample_from_logits,
                                    scatter_to_vocab,
                                    screened_bytes_per_query,
                                    screened_flops_per_query)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_desc


class ScreenedCudaHead(SoftmaxHead):
    name = "screened-cuda"
    supports_dist = True

    def __init__(self, W: torch.Tensor, b: torch.Tensor, screen: ScreenParams,
                 fused: bool = True):
        require_screen(screen, "ScreenedCudaHead")
        if screen.block != V_BLK:
            raise ScreenBlockError(
                f"the CUDA head needs a {V_BLK}-word block-candidate screen "
                f"(got block={screen.block}); fit with vocab_block={V_BLK}")
        self.W = W
        self.b = b
        self.screen = screen
        self.fused = fused
        self._Wb = None
        self._bb = None

    def prepare(self) -> "ScreenedCudaHead":
        if self._Wb is None:
            self._Wb, self._bb = ops.pack_head_blocks(self.W, self.b)
        return self

    @property
    def packed_shape(self):
        """(n_blk, V_BLK, d) of the packed weights."""
        self.prepare()
        return tuple(self._Wb.shape)

    @property
    def packed_nbytes(self) -> int:
        """Bytes of the packed weights and bias."""
        self.prepare()
        return int(self._Wb.nbytes + self._bb.nbytes)

    def _args(self, h):
        self.prepare()
        return (self._Wb, self._bb, self.screen.v, self.screen.cand_idx,
                h.contiguous())

    def topk(self, h, k: int):
        if self.fused:
            ids, vals, _ = ops.screened_fused_topk(*self._args(h), k=k)
            return ids, vals
        return ops.screened_topk(*self._args(h), k=k)

    def topk_logprobs(self, h, k: int):
        """§4.2 log-softmax over the routed candidate set. Fused path: top-k
        raw logits minus the kernel's on-chip logZ, with an explicit −inf
        guard — a row whose candidate union is all-sentinel has logZ = −∞
        and gets NEG_INF log-probs (probability 0 everywhere), never NaN."""
        if self.fused:
            ids, vals, logz = ops.screened_fused_topk(*self._args(h), k=k)
            lp = torch.where(torch.isfinite(logz)[:, None],
                             vals - logz[:, None], NEG_INF)
            return ids, lp
        logits, word_ids = ops.screened_candidate_logits(*self._args(h))
        lp = torch.log_softmax(logits, dim=-1)
        # same empty-row convention as the fused kernel: the escape hatch
        # must not change semantics
        empty = torch.all(logits <= NEG_INF / 2, dim=-1)
        lp = torch.where(empty[:, None], NEG_INF, lp)
        vals, pos = topk_desc(lp, k)
        return torch.gather(word_ids, 1, pos), vals

    def sample(self, h, temperature: float = 1.0, top_p: float = 1.0,
               generator=None, gumbel=None):
        """The noise is (B, K, V_BLK) standard Gumbel noise (the fused path
        scales it by the temperature; the unfused one reads it as
        (B, K·V_BLK))."""
        gumbel = self.noise(h, temperature, generator, gumbel)
        if self.fused and top_p >= 1.0:
            if temperature <= 0:
                return self.topk(h, 1)[0][:, 0]
            return ops.screened_fused_sample(*self._args(h),
                                             temperature=temperature,
                                             gumbel=gumbel)
        # nucleus sampling (and fused=False) needs the full candidate
        # distribution — unfused gather path
        logits, word_ids = ops.screened_candidate_logits(*self._args(h))
        choice = sample_from_logits(logits, temperature, top_p, gumbel)
        return torch.gather(word_ids, 1, choice[:, None].long())[:, 0]

    def dist_logits(self, h) -> torch.Tensor:
        """The routed candidates' logits in vocab coordinates, NEG_INF
        elsewhere: the ``cluster_route`` kernel, then the ``screened_logits``
        gather kernel (sentinel slots masked to NEG_INF), scattered into a
        (B, n_blk·V_BLK + 1) buffer and cut to the vocabulary. This head's
        sentinel word id is n_blk·V_BLK (not ``vocab_size``), and the padded
        rows of the last tile lie past the vocabulary, so the cut drops
        both. Its support is the set ``sample`` draws from (fused or not:
        the fused draw is an exact categorical over the same candidates)."""
        logits, word_ids = ops.screened_candidate_logits(*self._args(h))
        n_blk = self._Wb.shape[0]
        return scatter_to_vocab(logits, word_ids, n_blk * V_BLK,
                                self.screen.vocab_size)

    def noise_shape(self, batch: int, temperature: float):
        return None if temperature <= 0 else (batch, self.screen.c_max, V_BLK)

    @property
    def flops_per_query(self) -> float:
        return screened_flops_per_query(self.screen, self.W.shape[1])

    @property
    def bytes_per_query(self) -> float:
        """Fused: router + candidate tiles stream once, only O(k ≤ V_BLK)
        results are written. Unfused: the full K·V_BLK candidate-logit row
        is written back and re-read by masking + top-k."""
        writeback = (float(V_BLK) if self.fused
                     else float(self.screen.c_max * V_BLK))
        return screened_bytes_per_query(self.screen, self.W.shape[1],
                                        writeback_floats=writeback)
