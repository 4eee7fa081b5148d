"""Rotary position embeddings (standard RoPE). Twin of
``repro/layers/rope.py``; M-RoPE comes with the vlm family (ROADMAP.md,
Queue 1)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary pairs: (head_dim//2,) float32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def _rotate(x, cos, sin):
    # x: (..., head_dim) with pairs (x1, x2) in the two halves convention
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Standard RoPE. x: (B, T, H, D); positions: (B, T) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (D/2,)
    ang = positions.float()[..., None] * freqs                    # (B, T, D/2)
    cos = torch.cos(ang)[..., None, :]                            # (B, T, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)
