"""The precisions the plain reference computes its products in.

``float32``: IEEE float32 products, the reference itself. ``tf32``: each
product's operands rounded to TF32's 10-bit mantissa (round to nearest),
accumulated in float32, as the tensor cores take float32 with TF32 on: the
control of a float32 configuration. ``fp8``: each product's operands
rounded to float8 e4m3 (per-tensor scale, amax → 448), accumulated in
float32: the control of a bfloat16 configuration. The roundings are
emulated, so every precision gives the same numbers on the card and on the
CPU. Elementwise work stays float32. Imports nothing of the program.
"""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0
PRECISIONS = ("float32", "tf32", "fp8")


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest value with a 10-bit mantissa."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """float32 → float8 e4m3 under one per-tensor scale, back to float32."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """``mm(a, b)``: a (..., k) @ b (k, n) in this precision, float32 out;
    ``scope()``: the context a pass runs in (TF32 off for PyTorch's own
    float32 products, restored after)."""

    def __init__(self, name: str):
        if name not in PRECISIONS:
            raise ValueError(f"unknown precision {name!r}: {PRECISIONS}")
        self.name = name
        self._round = {"float32": lambda t: t.float(), "tf32": tf32_round,
                       "fp8": fp8_round}[name]

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._round(a) @ self._round(b)

    @contextlib.contextmanager
    def scope(self):
        cm, cd = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32 = cm
            torch.backends.cudnn.allow_tf32 = cd


def control_of(dtype: str) -> str:
    """The control's precision for a configuration's ``dtype``: the
    nearest below it."""
    return {"float32": "tf32", "bfloat16": "fp8"}[dtype]
