"""Inputs shared by the port's tests and ``chip_smoke.py``."""
from __future__ import annotations

from typing import Dict

import torch


def screen_id_patterns(g: torch.Generator, n_blk: int, B: int,
                       K: int) -> Dict[str, torch.Tensor]:
    """{name: (B, K) int32 block ids on the CPU} that stress the gather
    kernels' grid: random, a tile repeated within each row, tiles shared
    across rows, every row on one cluster, sentinels (n_blk and -1) beside
    tile 0 plus an all-sentinel row, and (B = 20) a beam of 4 groups of 5
    rows, each group on one cluster."""
    base = torch.randint(0, n_blk, (B, K), generator=g, dtype=torch.int32)
    pats = {"random": base.clone()}
    x = base.clone()
    x[:, 1::2] = x[:, ::2]
    pats["repeated_in_row"] = x
    x = base.clone()
    x[:, ::3] = base[0, ::3]
    pats["shared_across_rows"] = x
    pats["one_cluster"] = base[:1].repeat(B, 1)
    x = base.clone()
    x[:, 0] = x[:, 7 % K] = 0
    x[:, 3 % K] = n_blk
    x[:, 5 % K] = -1
    if B > 1:
        x[-1] = n_blk
    pats["sentinels_and_tile0"] = x
    if B == 20:
        groups = torch.randint(0, n_blk, (4, K), generator=g,
                               dtype=torch.int32)
        pats["beam"] = groups.repeat_interleave(5, 0)
    return {k: v.contiguous() for k, v in pats.items()}
