"""Roofline of one counted step on one H100 (no clock).

Twin of ``repro/launch/roofline.py``. Three terms, in seconds:

  compute    = FLOPs / the peak of the step's dtype (bf16 989 TFLOP/s on
               the tensor cores; float32 67 TFLOP/s outside them, TF32
               being off for the port's PyTorch products)
  memory     = bytes / HBM (3.35 TB/s)
  collective = collective bytes / NVLink (450 GB/s each way)

The peaks are ``launch/mesh.py``'s. FLOPs, bytes and collective bytes come
from ``launch/op_cost.count_cost`` (the reference takes them from its HLO
cost model over the compiled module); collective bytes are result bytes
per op, the reference's convention. Eager PyTorch does not fuse, so
``memory_s`` counts each op's operands and results: an upper bound where
the reference's post-fusion count is closer to the traffic a fused step
moves.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_F32)
from repro_torch.launch.op_cost import OpCost


def peak_flops(dtype) -> float:
    """The H100's peak for products in ``dtype``: bf16 and fp16 on the
    tensor cores, anything else at the float32 rate."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return PEAK_FLOPS_BF16 if dt in (torch.bfloat16, torch.float16) \
        else PEAK_FLOPS_F32


@dataclass
class Roofline:
    flops: float                 # per-device FLOPs
    bytes_accessed: float        # per-device bytes
    collective_bytes: float      # per-device collective result bytes
    collectives: dict = field(default_factory=dict)
    peak_flops: float = PEAK_FLOPS_BF16

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "bytes_per_dev": self.bytes_accessed,
            "collective_bytes_per_dev": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "collectives": self.collectives,
        }


def roofline_from_cost(cost: OpCost, dtype) -> Roofline:
    """The roofline of a ``count_cost`` count, its compute term at the peak
    of ``dtype`` (the step's: its config's or its weights')."""
    return Roofline(flops=cost.flops, bytes_accessed=cost.bytes_accessed,
                    collective_bytes=cost.collective_bytes,
                    collectives=cost.collectives,
                    peak_flops=peak_flops(dtype))


def model_flops_per_token(n_active_params: int) -> float:
    """MODEL_FLOPS = 6·N per token (fwd+bwd); 2·N for inference fwd."""
    return 6.0 * n_active_params
