"""ScreenedHead — the paper's L2S prediction process in plain torch: route
z(h) = argmax_t v_t·h, exact softmax restricted to cluster z's learned
candidate set. Twin of ``repro/heads/screened.py``; with ``exact`` it is the
oracle the ``screened-cuda`` head is held against."""
from __future__ import annotations

import torch

from repro_torch.core.screening import (ScreenParams, assign_clusters,
                                        screened_logits, screened_topk)
from repro_torch.heads.base import (NEG_INF, SoftmaxHead, require_screen,
                                    sample_from_logits, scatter_to_vocab,
                                    screened_bytes_per_query,
                                    screened_flops_per_query)
from repro_torch.kernels.ref import topk_desc


class ScreenedHead(SoftmaxHead):
    name = "screened"
    supports_dist = True

    def __init__(self, W: torch.Tensor, b: torch.Tensor, screen: ScreenParams):
        require_screen(screen, "ScreenedHead")
        self.W = W
        self.b = b
        self.screen = screen

    def _candidate_logits(self, h):
        cluster = assign_clusters(self.screen.v, h)
        return screened_logits(self.W, self.b, self.screen, h, cluster)

    def topk(self, h, k: int):
        return screened_topk(self.W, self.b, self.screen, h, k)

    def topk_logprobs(self, h, k: int):
        """Log-softmax over the ENTIRE routed candidate set (paper §4.2),
        then top-k. A row routed to a cluster with no candidates is
        probability 0 everywhere (NEG_INF), never NaN."""
        logits, word_ids = self._candidate_logits(h)
        logits = logits.float()
        lp = torch.log_softmax(logits, dim=-1)
        empty = torch.all(logits <= NEG_INF / 2, dim=-1)
        lp = torch.where(empty[:, None], NEG_INF, lp)
        vals, pos = topk_desc(lp, k)
        return torch.gather(word_ids, 1, pos).to(torch.int32), vals

    def next(self, h):
        return self.topk(h, 1)[0][:, 0]

    def dist_logits(self, h) -> torch.Tensor:
        """Candidate logits scattered to vocab coordinates: NEG_INF off the
        routed candidate set. The padding sentinel word id is
        ``vocab_size``, so scattering into a (B, V+1) buffer and dropping
        the last column discards it (padded candidate logits are NEG_INF
        anyway, so duplicate sentinel writes all agree); a block screen's
        padded rows past the vocabulary are cut off with it, where the
        reference's scatter drops them."""
        logits, word_ids = self._candidate_logits(h)
        V, blk = self.screen.vocab_size, self.screen.block
        return scatter_to_vocab(logits, word_ids, -(-V // blk) * blk, V)

    def sample(self, h, temperature: float = 1.0, top_p: float = 1.0,
               generator=None, gumbel=None):
        """Temperature/nucleus sample WITHIN the routed candidate set
        (probability 0 elsewhere)."""
        logits, word_ids = self._candidate_logits(h)
        choice = sample_from_logits(
            logits.float(), temperature, top_p,
            self.noise(h, temperature, generator, gumbel))
        return torch.gather(word_ids, 1, choice[:, None].long())[:, 0].to(
            torch.int32)

    def noise_shape(self, batch: int, temperature: float):
        if temperature <= 0:
            return None
        return (batch, self.screen.c_max * self.screen.block)

    @property
    def flops_per_query(self) -> float:
        return screened_flops_per_query(self.screen, self.W.shape[1])

    @property
    def bytes_per_query(self) -> float:
        """The (C_max·block) candidate-logit row is written back between
        the gather-matmul and the top-k."""
        return screened_bytes_per_query(
            self.screen, self.W.shape[1],
            writeback_floats=float(self.screen.c_max * self.screen.block))
