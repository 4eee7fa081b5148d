"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE. Twin of
``repro/layers/rope.py``.

M-RoPE (arXiv:2409.12191): the rotary channel pairs are split into three
sections (temporal / height / width, 2:1:1), each rotated by its own
component of a 3-part position id. For text tokens the three components are
equal, so M-RoPE gives RoPE's rotation. The stub vision frontend's patches
take (0, h, w) on their grid. Plain PyTorch: the JAX package has no kernel
for it either.
"""
from __future__ import annotations

import torch

# share of the rotary pairs per (temporal, height, width) section — Qwen2-VL
MROPE_SECTIONS = (2, 1, 1)


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


def mrope_sections(half: int, device=None) -> torch.Tensor:
    """(half,) int64: the position component (0 t, 1 h, 2 w) of each
    rotary pair, sections cut at the rounded shares of MROPE_SECTIONS (the
    last section ends at ``half``): 32 / 48 / 64 at half = 64."""
    total = sum(MROPE_SECTIONS)
    section_of = torch.zeros((half,), dtype=torch.long, device=device)
    prev = acc = 0
    for i, s in enumerate(MROPE_SECTIONS):
        acc += int(round(half * s / total))
        end = half if i == len(MROPE_SECTIONS) - 1 else acc
        section_of[prev:end] = i
        prev = end
    return section_of


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float = 10000.0) -> torch.Tensor:
    """M-RoPE. x: (B, T, H, D); positions3: (B, T, 3) int (t, h, w)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)               # (half,)
    sec = mrope_sections(half, x.device)
    pos = positions3.float().index_select(-1, sec)                 # (B, T, half)
    ang = pos * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def mrope_positions(batch: int, num_patch: int, text_len: int,
                    grid_hw: tuple | None = None,
                    device=None) -> torch.Tensor:
    """(batch, num_patch + text_len, 3) int32 position ids on ``device``: the
    patch grid, (0, h, w) row by row, then text tokens whose three
    components are equal, counting from max(gh, gw) (the Qwen2-VL
    convention). Without ``grid_hw`` the grid is side x P / side, side the
    largest divisor of P not above its square root (16 x 16 at P = 256)."""
    if num_patch == 0:
        t = torch.arange(text_len, dtype=torch.int32, device=device)
        return t[None, :, None].expand(batch, text_len, 3)
    if grid_hw is None:
        side = int(num_patch ** 0.5)
        while num_patch % side:
            side -= 1
        grid_hw = (side, num_patch // side)
    gh, gw = grid_hw
    hh, ww = torch.meshgrid(torch.arange(gh, dtype=torch.int32, device=device),
                            torch.arange(gw, dtype=torch.int32, device=device),
                            indexing="ij")
    patch = torch.stack([torch.zeros_like(hh), hh, ww], dim=-1).reshape(-1, 3)
    t = max(gh, gw) + torch.arange(text_len, dtype=torch.int32, device=device)
    pos = torch.cat([patch, torch.stack([t, t, t], dim=-1)], dim=0)
    return pos[None].expand(batch, *pos.shape)
