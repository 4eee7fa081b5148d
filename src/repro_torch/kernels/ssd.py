"""ssd_intra: the Mamba2 SSD intra-chunk dual form (arXiv:2405.21060).

Twin of ``repro/kernels/ssd.py``. For each (batch, chunk, head), with x̄ the
dt-weighted input and l the cumulative log decay inside the chunk:

    y[t] = Σ_{s ≤ t} exp(l_t − l_s) · (C_t·B_s) · x̄_s
    S    = Σ_s exp(l_Q − l_s) · B_s ⊗ x̄_s                  (chunk state)

Head h reads B/C group ``h // (H/G)``. The decay is masked BEFORE the exp,
so a dead position is exp(−1e30) = 0, never exp of a positive difference.

On a CUDA tensor ``ssd_intra`` launches ``csrc/ssd.cu``; on a CPU tensor it
runs ``ssd_intra_plain``, the twin of the reference's ``ssd_intra_ref``; on a
meta tensor it returns empty results (the dry run). Under
``launch/op_cost.count_cost`` each call records one ``ssd_intra`` op (and
each backward one ``ssd_intra_bwd``; ``kernels/cost.py``), counted as
``chip_smoke.py``'s bounds count them.
The inter-chunk recurrence stays in ``repro_torch.layers.ssm``.

``ssd_intra`` is differentiable (``SSDIntraFn``). Its backward is the
gradient the reference takes through XLA (``repro/layers/ssm.py``'s
intra-chunk einsums), written out in closed form: with
M[t,s] = (C_t·B_s)·E[t,s], E[t,s] = exp(l_t − l_s) for s ≤ t else 0, and
w_s = exp(l_{Q−1} − l_s),

    dxw = Mᵀ·dy + (B∘w)·dS               dM = dy·xwᵀ (causal part)
    dC  = (dM∘E)·B                        dB = (dM∘E)ᵀ·C + w∘(xw·dSᵀ)
    dl_t += Σ_s G[t,s],  dl_s −= Σ_t G[t,s],  G = dM∘M
    u_s = w_s·(B_s·(dS·xw_s)):  dl_s −= u_s,  dl_{Q−1} += Σ_s u_s

with dB and dC summed over the H/G heads of a group. On a CUDA tensor the
backward launches ``csrc/ssd_bwd.cu``, whose products run on the tensor
cores in split TF32 (each operand split into a TF32 high and low part,
three TF32 products for one float32 product, float32 accumulators; within
1e-4 of the largest magnitude of each gradient); everything else in it,
and the whole forward kernel, stays IEEE float32. On a CPU tensor it runs
``ssd_intra_bwd_plain``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import cost
from repro_torch.utils import shard

NEG_INF = -1e30


def ssd_intra_plain(xw, Bm, Cm, l) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version. xw (B,nc,Q,H,P); Bm/Cm (B,nc,Q,G,N);
    l (B,nc,Q,H) → (y (B,nc,Q,H,P), S (B,nc,H,N,P)), float32."""
    H, G, Q = xw.shape[3], Bm.shape[3], xw.shape[2]
    rep = H // G
    Bh = Bm.float().repeat_interleave(rep, dim=3)
    Ch = Cm.float().repeat_interleave(rep, dim=3)
    xf, lf = xw.float(), l.float()
    diff = lf[:, :, :, None, :] - lf[:, :, None, :, :]           # (B,nc,t,s,H)
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=xw.device).tril()[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, diff, NEG_INF))
    cb = torch.einsum("bcqhn,bcshn->bcqsh", Ch, Bh)
    y = torch.einsum("bcqsh,bcshp->bcqhp", cb * decay, xf)
    w_end = torch.exp(lf[:, :, -1:, :] - lf)
    S = torch.einsum("bcqhn,bcqhp->bchnp", Bh * w_end[..., None], xf)
    return y, S


def ssd_intra_bwd_plain(xw, Bm, Cm, l, dy, dS) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch gradient of ``ssd_intra_plain``, in closed form (the
    module docstring). dy (B,nc,Q,H,P), dS (B,nc,H,N,P) → (dxw, dBm, dCm,
    dl), float32, in the shapes of xw, Bm, Cm and l."""
    Bsz, nc, Q, H, P = xw.shape
    G, N = Bm.shape[3], Bm.shape[4]
    rep = H // G
    Bh = Bm.float().repeat_interleave(rep, dim=3)                 # (B,nc,Q,H,N)
    Ch = Cm.float().repeat_interleave(rep, dim=3)
    xf, lf, dy, dS = xw.float(), l.float(), dy.float(), dS.float()
    diff = lf[:, :, :, None, :] - lf[:, :, None, :, :]           # (B,nc,t,s,H)
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=xw.device).tril()[None, None, :, :, None]
    E = torch.exp(torch.where(causal, diff, NEG_INF))
    M = torch.einsum("bcqhn,bcshn->bcqsh", Ch, Bh) * E
    w = torch.exp(lf[:, :, -1:, :] - lf)                          # (B,nc,s,H)
    dxw = (torch.einsum("bcqsh,bcqhp->bcshp", M, dy)
           + torch.einsum("bcshn,bchnp->bcshp", Bh * w[..., None], dS))
    dM = torch.einsum("bcqhp,bcshp->bcqsh", dy, xf)
    dCB = dM * E
    V = torch.einsum("bcshp,bchnp->bcshn", xf, dS)                # dS·xw_s
    dCh = torch.einsum("bcqsh,bcshn->bcqhn", dCB, Bh)
    dBh = torch.einsum("bcqsh,bcqhn->bcshn", dCB, Ch) + w[..., None] * V
    Gm = dM * M
    u = w * torch.sum(Bh * V, dim=-1)                             # (B,nc,s,H)
    dl = torch.sum(Gm, dim=3) - torch.sum(Gm, dim=2) - u
    dl[:, :, -1] += torch.sum(u, dim=2)
    dB = dBh.reshape(Bsz, nc, Q, G, rep, N).sum(dim=4)
    dC = dCh.reshape(Bsz, nc, Q, G, rep, N).sum(dim=4)
    return dxw, dB, dC, dl


def _check_shapes(xw, Bm, Cm, l) -> None:
    from repro_torch.kernels import ops
    dev = xw.device
    ops.check_tensor(xw, "xw", torch.float32, 5, dev)
    ops.check_tensor(Bm, "Bm", torch.float32, 5, dev)
    ops.check_tensor(Cm, "Cm", torch.float32, 5, dev)
    ops.check_tensor(l, "l", torch.float32, 4, dev)
    B, nc, Q, H, P = xw.shape
    G = Bm.shape[3]
    if (tuple(Bm.shape[:3]) != (B, nc, Q) or Cm.shape != Bm.shape
            or tuple(l.shape) != (B, nc, Q, H) or G < 1 or H % G):
        raise ValueError(f"ssd_intra: shapes xw {tuple(xw.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, l "
                         f"{tuple(l.shape)} do not match (G must divide H)")


def _ssd_intra_fwd(xw, Bm, Cm, l) -> Tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.kernels import ops
    _check_shapes(xw, Bm, Cm, l)
    dev = xw.device
    B, nc, Q, H, P = xw.shape
    G, N = Bm.shape[3], Bm.shape[4]
    with cost.suspended():
        if dev.type == "cpu":
            y, S = ssd_intra_plain(xw, Bm, Cm, l)
        else:
            y = torch.empty((B, nc, Q, H, P), dtype=torch.float32, device=dev)
            S = torch.empty((B, nc, H, N, P), dtype=torch.float32, device=dev)
            if dev.type == "cuda":
                ops.launch("ssd_intra", "ssd", "l2s_ssd_intra", dev,
                           xw.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                           l.data_ptr(), y.data_ptr(), S.data_ptr(), B * nc,
                           Q, H, P, G, N)
    # inputs read and outputs written once; C·B and M·x over the causal
    # half (s <= t) and the chunk state
    n_x, n_b, n_l, n_s = xw.numel(), Bm.numel(), l.numel(), S.numel()
    pairs = Q * (Q + 1) // 2
    cost.record_kernel("ssd_intra", [y, S],
                          B * nc * H * (2 * pairs * (N + P) + 2 * Q * N * P),
                          4 * (2 * n_x + 2 * n_b + n_l + n_s))
    return y, S


def bwd_scratch_floats(BC: int, Q: int, H: int, P: int, N: int) -> int:
    """Floats of the backward kernel's scratch (``csrc/ssd_bwd.cu``): the
    per-head dB and dC, the row sums of G, its column sums per 64-row s
    tile, u_s per output slice of P (one up to P = 128, else 128 wide) and
    the sum of u per s tile and slice."""
    n_tt, n_pc = -(-Q // 64), -(-P // 128)
    return BC * Q * H * (2 * N + 1 + n_tt + n_pc) + BC * H * n_tt * n_pc


def ssd_intra_bwd(xw, Bm, Cm, l, dy, dS) -> Tuple[torch.Tensor, ...]:
    """Gradient of ``ssd_intra`` (arguments as ``ssd_intra_bwd_plain``'s):
    on a CUDA tensor the kernel of ``csrc/ssd_bwd.cu``, on a CPU tensor
    the plain version. → (dxw, dBm, dCm, dl) float32. DTensors run per
    device, split as ``ssd_intra``'s."""
    from repro_torch.kernels import ops
    if shard.any_dtensor(xw, Bm, Cm, l, dy, dS):
        from torch.distributed.tensor import Partial, Shard
        px, pb, pl, py, pS = _placements(xw, Bm)
        # where the heads split and B/C do not (G = 1), a device's dB and
        # dC are its heads' part of the sum over the group's heads
        pd = tuple(Partial() if isinstance(p, Shard) and q != p else q
                   for p, q in zip(px, pb))
        return shard.per_device(ssd_intra_bwd, (xw, Bm, Cm, l, dy, dS),
                                (px, pb, pb, pl, py, pS), (px, pd, pd, pl))
    _check_shapes(xw, Bm, Cm, l)
    dev = xw.device
    B, nc, Q, H, P = xw.shape
    G, N = Bm.shape[3], Bm.shape[4]
    ops.check_tensor(dy, "dy", torch.float32, 5, dev)
    ops.check_tensor(dS, "dS", torch.float32, 5, dev)
    if dy.shape != xw.shape or tuple(dS.shape) != (B, nc, H, N, P):
        raise ValueError(f"ssd_intra_bwd: dy {tuple(dy.shape)} / dS "
                         f"{tuple(dS.shape)} do not match xw "
                         f"{tuple(xw.shape)} and N = {N}")
    with cost.suspended():
        if dev.type == "cpu":
            out = ssd_intra_bwd_plain(xw, Bm, Cm, l, dy, dS)
        else:
            out = tuple(torch.empty_like(t) for t in (xw, Bm, Cm, l))
            if dev.type == "cuda":
                scratch = torch.empty(bwd_scratch_floats(B * nc, Q, H, P, N),
                                      dtype=torch.float32, device=dev)
                ops.launch("ssd_intra_bwd", "ssd_bwd", "l2s_ssd_intra_bwd",
                           dev, xw.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                           l.data_ptr(), dy.data_ptr(), dS.data_ptr(),
                           *(t.data_ptr() for t in out), scratch.data_ptr(),
                           B * nc, Q, H, P, G, N)
    # xw, B, C, l, dy and dS read once, the four gradients written once;
    # five products over the causal half and two Q × N × P ones
    n_x, n_b, n_l, n_s = xw.numel(), Bm.numel(), l.numel(), dS.numel()
    pairs = Q * (Q + 1) // 2
    cost.record_kernel(
        "ssd_intra_bwd", out,
        B * nc * H * (2 * pairs * (3 * N + 2 * P) + 4 * Q * N * P),
        4 * (3 * n_x + 4 * n_b + 2 * n_l + n_s))
    return out


class SSDIntraFn(torch.autograd.Function):
    """``ssd_intra`` under autograd: the forward launch, and a backward
    that launches the backward kernel (CPU tensors: the plain versions).
    The saved inputs are the contiguous tensors the forward read, and
    nothing of a launch's outputs is kept, so a checkpointed recompute
    sees the same inputs."""

    @staticmethod
    def forward(ctx, xw, Bm, Cm, l):
        ctx.save_for_backward(xw, Bm, Cm, l)
        return _ssd_intra_fwd(xw, Bm, Cm, l)

    @staticmethod
    def backward(ctx, dy, dS):
        xw, Bm, Cm, l = ctx.saved_tensors
        B, nc, Q, H, P = xw.shape
        N = Bm.shape[4]
        dy = torch.zeros_like(xw) if dy is None else dy.contiguous()
        dS = xw.new_zeros((B, nc, H, N, P)) if dS is None else dS.contiguous()
        return ssd_intra_bwd(xw, Bm, Cm, l, dy, dS)


def ssd_intra(xw, Bm, Cm, l) -> Tuple[torch.Tensor, torch.Tensor]:
    """xw (B, nc, Q, H, P) f32 dt-weighted inputs; Bm/Cm (B, nc, Q, G, N)
    f32; l (B, nc, Q, H) f32 cumulative log decay; G divides H.
    → (y (B, nc, Q, H, P) f32, S (B, nc, H, N, P) f32), differentiable
    in all four inputs. DTensors run per device (``_placements``), the
    backward too."""
    if shard.any_dtensor(xw, Bm, Cm, l):
        px, pb, pl, py, pS = _placements(xw, Bm)
        return shard.per_device(SSDIntraFn.apply, (xw, Bm, Cm, l),
                                (px, pb, pb, pl), (py, pS))
    return SSDIntraFn.apply(xw, Bm, Cm, l)


def _placements(xw, Bm):
    """Per-device placements of ``ssd_intra``'s operands and results, as
    GSPMD splits the reference's: the batch over the data axes where xw
    splits it; the heads over "model" where they divide it and each
    device's heads read its own B/C groups (G divides "model" too, or
    G = 1). → (xw, Bm and Cm, l, y, S)."""
    from torch.distributed.tensor import Shard
    mesh = shard.mesh_of(xw, Bm)
    bp = shard.batch_placements(xw, mesh)
    H, G = xw.shape[3], Bm.shape[3]
    names = mesh.mesh_dim_names or ()
    m = names.index("model") if "model" in names else None
    if m is None or H % mesh.size(m) or (G > 1 and G % mesh.size(m)):
        return bp, bp, bp, bp, bp

    def at(dim, split=True):
        return tuple(Shard(dim) if i == m and split else p
                     for i, p in enumerate(bp))
    return at(3), at(3, G > 1), at(3), at(3), at(2)
