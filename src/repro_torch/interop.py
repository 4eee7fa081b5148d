"""Weights and screens between the reference's layout and the port's, through
numpy only, in both directions.

The reference (``src/repro``) keeps params as a pytree of nested dicts and
lists — LSTM ``{"embed": {embedding, lm_head, lm_bias}, "lstm": {"layers":
[{wx, wh, b}]}}``, the others ``{"embed", "stack": {"blocks"
(stacked on a
leading L axis; a moe layer's ``moe`` leaves ``w_router`` (L, d, E),
``w_gate`` / ``w_up`` (L, E, d, ff), ``w_down`` (L, E, ff, d)),
"final_norm", "shared"}}``, plus the vlm's ``vision_proj`` or the audio
encoder's ``frame_proj`` (d, d) beside them — and a screen as
``ScreenParams(v, cand_idx, cand_len, vocab_size, block)``. The caller
converts those arrays to numpy (``np.asarray``) on its side, so this package
never imports JAX; the other way, ``params_to_numpy`` and ``screen_to_numpy``
give numpy arrays that the reference takes with ``jnp.asarray``. The layouts
are the same: the LSTM keeps the fused-gate (d, 4d) matrices in i, f, g, o
order, attention its (d, H, hd) projections.

bfloat16 leaves (a bf16 reference model's) cross bit for bit without this
package importing ``ml_dtypes``: a numpy array whose dtype is named
``bfloat16`` is read through a 16-bit integer view into a
``torch.bfloat16`` tensor, and ``params_to_numpy(tree, bf16=...)`` writes a
bf16 tensor's bits back into an array of the numpy dtype the caller names
(``ml_dtypes.bfloat16``, which is ``jnp.bfloat16``'s); without it a bf16
leaf comes back widened to float32, exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.screening import ScreenParams
from repro_torch.tree import tree_map


def _tensor(a, dtype=None) -> torch.Tensor:
    arr = np.array(a, dtype=dtype, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _array(t: torch.Tensor, bf16=None) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    if bf16 is None:
        return t.float().numpy()
    return t.view(torch.int16).numpy().view(bf16)


def params_from_numpy(tree):
    """The reference's params pytree, its leaves numpy arrays (any nesting
    of dicts and lists) → the same tree of CPU tensors (``DecodeEngine``
    moves them to its device)."""
    return tree_map(_tensor, tree)


def screen_from_numpy(v, cand_idx, cand_len, vocab_size: int,
                      block: int = 1) -> ScreenParams:
    """A screen's arrays (numpy) → ``ScreenParams`` of CPU tensors."""
    return ScreenParams(v=_tensor(v, np.float32),
                        cand_idx=_tensor(cand_idx, np.int32),
                        cand_len=_tensor(cand_len, np.int32),
                        vocab_size=int(vocab_size), block=int(block))


def params_to_numpy(tree, bf16=None):
    """The port's params tree (tensors on any device) → the same tree of
    numpy arrays, the reference's layout. ``bf16``: the numpy bfloat16
    dtype to carry bf16 leaves in, bit for bit (else they are widened to
    float32)."""
    return tree_map(lambda t: _array(t, bf16), tree)


def screen_to_numpy(screen: ScreenParams):
    """A port ``ScreenParams`` → (v, cand_idx, cand_len, vocab_size, block):
    numpy arrays and ints, the reference ``ScreenParams``'s fields."""
    return (screen.v.detach().cpu().numpy(),
            screen.cand_idx.cpu().numpy().astype(np.int32),
            screen.cand_len.cpu().numpy().astype(np.int32),
            int(screen.vocab_size), int(screen.block))
