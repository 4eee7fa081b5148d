"""cluster_route: fused cluster scoring + top-1 routing (paper Eq. (2)).

Twin of ``repro/kernels/route.py``. scores = h (B, d) · vᵀ (d, r);
cluster = argmax over r, the first index winning a tie. On a CUDA tensor
``cluster_route`` launches ``csrc/route.cu`` (one warp per cluster t, one
thread block cluster per 8 rows of h, merged through distributed shared
memory), which never writes the (B, r) score matrix; on a CPU tensor it runs
``cluster_route_plain``.
"""
from __future__ import annotations

import torch

MAX_D = 7040    # eight rows of h staged in 220 KB of one block's shared memory


def cluster_route_plain(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: h (B, d); v (r, d) → (B,) int32."""
    return torch.argmax(h @ v.T, dim=-1).to(torch.int32)


def cluster_route(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """h (B, d) f32; v (r, d) f32 → (B,) int32 cluster ids."""
    from repro_torch.kernels import ops
    dev = h.device
    ops.check_tensor(h, "h", torch.float32, 2, dev)
    ops.check_tensor(v, "v", torch.float32, 2, dev)
    (B, d), r = h.shape, v.shape[0]
    if v.shape[1] != d or r < 1:
        raise ValueError(f"v {tuple(v.shape)} does not match h {tuple(h.shape)}")
    if dev.type == "cpu":
        return cluster_route_plain(h, v)
    if d > MAX_D:
        raise ValueError(f"cluster_route: d={d} exceeds the kernel's {MAX_D}")
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    ops.launch("cluster_route", "route", "l2s_cluster_route", dev,
               h.data_ptr(), v.data_ptr(), out.data_ptr(), B, r, d)
    return out
