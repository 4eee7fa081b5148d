"""The yardstick's arithmetic: the H100's peaks, the least time of a piece
of work, and the FLOPs and bytes of the heads and of a served request
(the model's own FLOPs are counted by each family's reference,
``bench/reference/<family>.py::model_flops``).

Copies, kept here so that a later change to the program cannot move the
yardstick: the bound of ``chip_smoke.py::bound_ms`` (the larger of bytes
over HBM bandwidth and FLOPs over the peak), the peaks of
``repro_torch/launch/roofline.py`` (NVIDIA's data sheet, H100 SXM, dense:
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside them,
3.35 TB/s of HBM) and ``repro_torch/kernels/cost.py::distinct_tiles``.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the byte and
    the FLOP terms."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def distinct_tiles(block_ids: torch.Tensor, n_blk: int) -> int:
    """Tiles a launch over ``block_ids`` reads, each once: the distinct
    valid ids."""
    valid = (block_ids >= 0) & (block_ids < n_blk)
    return int(torch.unique(block_ids[valid]).numel())


# -- FLOPs of a request -------------------------------------------------------

def head_flops(cfg: dict, head: str, screen_words: float) -> float:
    """FLOPs of one head evaluation: exact 2·V·d; screened 2·(r + the
    routed cluster's real words)·d, ``screen_words`` the mean over the
    clusters of their real words."""
    d, V = int(cfg["d_model"]), int(cfg["vocab_size"])
    if head == "exact":
        return 2.0 * V * d
    return 2.0 * (int(cfg["screen"]["clusters"]) + screen_words) * d


def request_flops(cfg: dict, ref, head: str, screen_words: float,
                  prompt: int, new: int) -> float:
    """FLOPs of one served request: the model over its prompt and its
    new tokens but the last (whose h nothing reads), as the
    configuration's reference counts them (``ref.model_flops``), and one
    head evaluation per new token."""
    return ref.model_flops(cfg, 0, prompt + new - 1) \
        + new * head_flops(cfg, head, screen_words)


# -- a head call's least work -------------------------------------------------

def head_call_work(cfg: dict, head: str, rows: int, tile_words: int = 0,
                   row_words: int = 0) -> tuple:
    """(bytes, FLOPs) of one ``next(h)`` call on ``rows`` contexts, each
    input read once and each output written once. Exact: W and b whole,
    2·rows·V·d. Screened: v, and the distinct candidate tiles the rows'
    routes touch, ``tile_words`` real words in all; 2·rows·r·d for the
    route and 2·d a real word of each row's routed cluster, ``row_words``
    summed over the rows. Both read h and write one id a row."""
    d, V = int(cfg["d_model"]), int(cfg["vocab_size"])
    e = BYTES[cfg["dtype"]]
    io = rows * d * e + rows * 4
    if head == "exact":
        return V * (d + 1) * e + io, 2.0 * rows * V * d
    r = int(cfg["screen"]["clusters"])
    return (r * d * 4 + tile_words * (d + 1) * e + io,
            2.0 * rows * r * d + 2.0 * row_words * d)
