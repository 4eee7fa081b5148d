"""cluster_route: fused cluster scoring + top-1 routing (paper Eq. (2)).

Twin of ``repro/kernels/route.py``. scores = h (B, d) · vᵀ (d, r);
cluster = argmax over r, the first index winning a tie. On a CUDA tensor
``cluster_route`` launches ``csrc/route.cu`` (one warp per cluster t, one
thread block cluster per 8 rows of h, or per 4, 2 or 1 where eight rows of
d floats do not fit 220 KB of shared memory — 4 at qwen1.5-110b's d = 8192
— merged through distributed shared memory), which never writes the (B, r)
score matrix; on a CPU tensor it runs ``cluster_route_plain``; on a meta
tensor it returns an empty (B,) int32 result (the dry run). Under
``launch/op_cost.count_cost`` it records one ``cluster_route`` op
(``kernels/cost.py``), whatever the device.

h may be float32 or bfloat16 (a bf16 model's hidden state); v is float32,
as ``fit_l2s`` makes it. A bfloat16 h is promoted to float32 exactly, as the
reference's ``dot_general`` of a bf16 h and an f32 v promotes it, so its
routes are the float32 routes of the same values; on the card the bf16 body
of the kernel (``route_bf16_kernel``) converts h as it stages it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cost
from repro_torch.utils import shard

MAX_D = 56_320  # one row of h staged in 220 KB of one block's shared memory


def cluster_route_plain(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: h (B, d) f32 or bf16; v (r, d) f32 →
    (B,) int32."""
    return torch.argmax(h.float() @ v.T, dim=-1).to(torch.int32)


def cluster_route(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """h (B, d) f32 or bf16; v (r, d) f32 → (B,) int32 cluster ids.
    DTensors run per device: h and the routes batch-sharded, v
    replicated."""
    from repro_torch.kernels import ops
    if shard.any_dtensor(h, v):
        hp = shard.batch_placements(h, shard.mesh_of(h, v))
        return shard.per_device(cluster_route, (h, v), (hp, None), (hp,))
    dev = h.device
    ops.check_tensor(h, "h", ops.FLOATS, 2, dev)
    ops.check_tensor(v, "v", torch.float32, 2, dev)
    (B, d), r = h.shape, v.shape[0]
    if v.shape[1] != d or r < 1:
        raise ValueError(f"v {tuple(v.shape)} does not match h {tuple(h.shape)}")
    sfx = ops.BF16 if h.dtype == torch.bfloat16 else ""
    with cost.suspended():
        if dev.type == "cpu":
            out = cluster_route_plain(h, v)
        elif dev.type == "meta":
            out = torch.empty((B,), dtype=torch.int32, device=dev)
        else:
            if d > MAX_D:
                raise ValueError(f"cluster_route: d={d} exceeds the "
                                 f"kernel's {MAX_D}")
            out = torch.empty((B,), dtype=torch.int32, device=dev)
            ops.launch("cluster_route" + sfx, "route",
                       "l2s_cluster_route" + sfx, dev, h.data_ptr(),
                       v.data_ptr(), out.data_ptr(), B, r, d)
    # h and v read once, the routes written
    cost.record_kernel("cluster_route" + sfx, [out], 2 * B * r * d,
                          h.element_size() * B * d + 4 * (r * d + B))
    return out
