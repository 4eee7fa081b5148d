"""Inputs and references shared by the port's tests and ``chip_smoke.py``."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
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


def _body(step, slab):
    return step.body(slab)


def eager_generate(engine, prompts, max_new: int, head=None,
                   temperature: Optional[float] = None, top_p: float = 1.0,
                   seed: Optional[int] = None):
    """``engine.generate`` with each step's body run eagerly, never its
    CUDA graph: the reference the graph replays are held to, bit for bit.
    It leaves the engine's step cache holding the steps it ran, without
    graphs."""
    with torch.inference_mode():
        return engine._generate(prompts, max_new, engine.resolve_head(head),
                                temperature, top_p, seed, None, _body)


def eager_beam_search(engine, prompt, beam: int, max_new: int, head=None):
    """``engine.beam_search`` with each step's body run eagerly."""
    with torch.inference_mode():
        return engine._beam_search(prompt, beam, max_new,
                                   engine.resolve_head(head), _body)


def head_sampled_generate(engine, prompts, max_new: int, head,
                          temperature: float, top_p: float = 1.0,
                          seed: int = 0) -> np.ndarray:
    """The tokens a sampled ``engine.generate`` should give, drawn by the
    head's own ``sample(h, generator=...)`` from a generator seeded with
    ``seed``, the model stepped eagerly on a cache of its own: the
    reference for the engine's draw into its static noise buffer."""
    hd = engine.resolve_head(head)
    model, params, dev = engine.model, engine.params, engine.device
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                             device=dev)
    B, Tp = tokens.shape
    with torch.inference_mode():
        cache = model.init_cache(B, engine.max_len, dtype=engine.cache_dtype,
                                 device=dev)
        h, cache = model.prefill(params, {"tokens": tokens}, cache)
        h = h[:, -1].contiguous()
        out = []
        for i in range(max_new):
            tok = hd.sample(h, temperature, top_p, generator=g).to(
                torch.int32)
            out.append(tok)
            if i + 1 < max_new:
                pos = torch.tensor(Tp + i, dtype=torch.int32, device=dev)
                h, cache = model.decode_step(params, tok, cache, pos)
        return torch.stack(out, 1).cpu().numpy()
