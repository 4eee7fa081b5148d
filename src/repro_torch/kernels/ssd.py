"""ssd_intra: the Mamba2 SSD intra-chunk dual form (arXiv:2405.21060).

Twin of ``repro/kernels/ssd.py``. For each (batch, chunk, head), with x̄ the
dt-weighted input and l the cumulative log decay inside the chunk:

    y[t] = Σ_{s ≤ t} exp(l_t − l_s) · (C_t·B_s) · x̄_s
    S    = Σ_s exp(l_Q − l_s) · B_s ⊗ x̄_s                  (chunk state)

Head h reads B/C group ``h // (H/G)``. The decay is masked BEFORE the exp,
so a dead position is exp(−1e30) = 0, never exp of a positive difference.

On a CUDA tensor ``ssd_intra`` launches ``csrc/ssd.cu``; on a CPU tensor it
runs ``ssd_intra_plain``, the twin of the reference's ``ssd_intra_ref``.
The inter-chunk recurrence stays in ``repro_torch.layers.ssm``.
"""
from __future__ import annotations

from typing import Tuple

import torch

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


def ssd_intra(xw, Bm, Cm, l) -> Tuple[torch.Tensor, torch.Tensor]:
    """xw (B, nc, Q, H, P) f32 dt-weighted inputs; Bm/Cm (B, nc, Q, G, N)
    f32; l (B, nc, Q, H) f32 cumulative log decay; G divides H.
    → (y (B, nc, Q, H, P) f32, S (B, nc, H, N, P) f32)."""
    from repro_torch.kernels import ops
    dev = xw.device
    ops.check_tensor(xw, "xw", torch.float32, 5, dev)
    ops.check_tensor(Bm, "Bm", torch.float32, 5, dev)
    ops.check_tensor(Cm, "Cm", torch.float32, 5, dev)
    ops.check_tensor(l, "l", torch.float32, 4, dev)
    B, nc, Q, H, P = xw.shape
    G, N = Bm.shape[3], Bm.shape[4]
    if (tuple(Bm.shape[:3]) != (B, nc, Q) or Cm.shape != Bm.shape
            or tuple(l.shape) != (B, nc, Q, H) or G < 1 or H % G):
        raise ValueError(f"ssd_intra: shapes xw {tuple(xw.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, l "
                         f"{tuple(l.shape)} do not match (G must divide H)")
    if dev.type == "cpu":
        return ssd_intra_plain(xw, Bm, Cm, l)
    y = torch.empty((B, nc, Q, H, P), dtype=torch.float32, device=dev)
    S = torch.empty((B, nc, H, N, P), dtype=torch.float32, device=dev)
    ops.launch("ssd_intra", "ssd", "l2s_ssd_intra", dev,
               xw.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), l.data_ptr(),
               y.data_ptr(), S.data_ptr(), B * nc, Q, H, P, G, N)
    return y, S
