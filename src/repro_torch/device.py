"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (str or torch.device) → torch.device, checked.

    A CUDA device without a visible GPU raises instead of silently running
    on the CPU: the CPU is taken only when the caller asks for it. The
    ``meta`` device (shapes and dtypes, no storage) is taken only when the
    caller names it, as the dry run does (``launch/dryrun.py``); nothing
    falls back to it.

    On a CUDA device this also turns TF32 off for float32 matrix products
    and cuDNN (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` set to False, process-wide): the
    LSTM and the exact head's GEMV must stay in IEEE float32 to agree with
    the reference and with the hand-written kernels. The switch covers
    PyTorch's own products only: the SSD backward kernel
    (``csrc/ssd_bwd.cu``) runs its products on the tensor cores in split
    TF32 (three TF32 products for each float32 one, float32-grade
    results)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: device='cuda' requested but no CUDA GPU is "
                "available; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"repro_torch runs on 'cuda', 'cpu' or 'meta', got "
                         f"{dev}")
    return dev
