"""ExactHead — full-vocabulary softmax, the baseline every approximation is
measured against. Twin of ``repro/heads/exact.py``; the (B, L) GEMV stays a
``torch.matmul`` in the weights' dtype (IEEE float32, or bfloat16 for a bf16
model), as the reference leaves it to XLA, and the logits are then widened
to float32, the reference's rounding points."""
from __future__ import annotations

import torch

from repro_torch.heads.base import (SoftmaxHead, exact_bytes_per_query,
                                    exact_flops_per_query, sample_from_logits)
from repro_torch.kernels.ref import topk_desc


class ExactHead(SoftmaxHead):
    name = "exact"
    supports_dist = True

    def __init__(self, W: torch.Tensor, b: torch.Tensor):
        self.W = W
        self.b = b

    def logits(self, h) -> torch.Tensor:
        return (h @ self.W.T + self.b).float()

    def dist_logits(self, h) -> torch.Tensor:
        """Full-vocab logits: the exact head's sampling law is the raw
        softmax, the target distribution p speculative decoding verifies
        drafts against."""
        return self.logits(h)

    def topk(self, h, k: int):
        vals, ids = topk_desc(self.logits(h), k)
        return ids.to(torch.int32), vals

    def topk_logprobs(self, h, k: int):
        vals, ids = topk_desc(torch.log_softmax(self.logits(h), dim=-1), k)
        return ids.to(torch.int32), vals

    def next(self, h):
        return torch.argmax(self.logits(h), dim=-1).to(torch.int32)

    def sample(self, h, temperature: float = 1.0, top_p: float = 1.0,
               generator=None, gumbel=None):
        return sample_from_logits(self.logits(h), temperature, top_p,
                                  self.noise(h, temperature, generator,
                                              gumbel))

    def noise_shape(self, batch: int, temperature: float):
        return None if temperature <= 0 else (batch, self.W.shape[0])

    @property
    def flops_per_query(self) -> float:
        return exact_flops_per_query(*self.W.shape)

    @property
    def bytes_per_query(self) -> float:
        return exact_bytes_per_query(*self.W.shape, self.W.element_size())
