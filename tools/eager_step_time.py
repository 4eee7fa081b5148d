#!/usr/bin/env python3
"""Host-clock times of qwen2-vl-2b's eager steps (no CUDA graph; its
decode is host-bound, ~2,300 launches a step) on one NVIDIA GPU, for
comparing two trees of the port on the same card: the full-head and l2s
decode steps (B = 4, a 544-slot bf16 cache) and a 512-position prefill, at
full width and depth in bf16, random weights from a seed. Where the tree
has ``repro_torch/utils/shard.py`` it also prints what the mesh checks
cost without a mesh: each check's host time a call, and how many calls of
each function of that module one step makes.

    PYTHONPATH=<tree>/src python3 tools/eager_step_time.py [LABEL]

To compare two trees, run it in one session on one card with each tree's
``src`` in turn, as parent, change, change, parent. Each step's time is
the median of STEPS calls, each between two ``torch.cuda.synchronize``
calls. Prints one JSON line.
"""
from __future__ import annotations

import cProfile
import json
import pstats
import statistics
import sys
import time

ARCH = "qwen2-vl-2b"
B, CACHE, PREFILL = 4, 544, 512
STEPS = 20
CHECK_CALLS = 100_000


def timed(sync, fn, steps: int, warm: int = 3) -> float:
    """Median host seconds of ``fn()``, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    sync()
    ts = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def check_costs(torch, d: int, dev) -> dict:
    """Host µs a call of each mesh check without a mesh, on tensors of a
    decode step's shapes (the mean of CHECK_CALLS calls)."""
    from repro_torch.utils import shard
    x = torch.zeros((4, 1, d), device=dev)
    w = torch.zeros((d, 64), device=dev)
    make = lambda B: x                      # noqa: E731
    checks = {
        "any_dtensor (4 tensors, a kernel wrapper's)":
            lambda: shard.any_dtensor(x, w, x, w),
        "like": lambda: shard.like(x, x),
        "split_as": lambda: shard.split_as(x, 2, w, 1),
        "shard_batch": lambda: shard.shard_batch(x),
        "model_axis_size": shard.model_axis_size,
        "by_rows": lambda: shard.by_rows(make, x),
        "lookup (4 x 1 ids)": lambda: shard.lookup(
            w, torch.zeros((4, 1), dtype=torch.long, device=dev)),
    }
    out = {}
    for name, fn in checks.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(CHECK_CALLS):
            fn()
        out[name] = (time.perf_counter() - t0) / CHECK_CALLS * 1e6
    return out


def shard_calls(step) -> dict:
    """Calls of each function of ``utils/shard.py`` in one ``step()``
    (cProfile's primitive counts)."""
    prof = cProfile.Profile()
    prof.enable()
    step()
    prof.disable()
    st = pstats.Stats(prof)
    return {fn: cc for (path, _, fn), (cc, *_rest) in st.stats.items()
            if path.replace("\\", "/").endswith("repro_torch/utils/shard.py")}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import numpy as np
    import torch
    from repro_torch.configs import L2SConfig, ShapeConfig, get_config
    from repro_torch.configs.base import V_BLK
    from repro_torch.data.loader import input_specs
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import (abstract_screen, make_prefill_step,
                                          make_serve_step)
    from repro_torch.models import Model

    dev = resolve_device("cuda")
    cfg = get_config(ARCH)
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, B).astype(
        np.int32)).to(dev)
    pos = torch.tensor(CACHE // 2, dtype=torch.int32, device=dev)
    cache = model.init_cache(B, CACHE, dtype=torch.bfloat16, device=dev)
    v_meta, cand_meta = abstract_screen(cfg, L2SConfig())
    n_blk = -(-cfg.vocab_size // V_BLK)
    v = torch.randn(tuple(v_meta.shape), generator=gen, device=dev)
    cand = torch.from_numpy(rng.integers(0, n_blk + 1, tuple(
        cand_meta.shape)).astype(np.int32)).to(dev)
    batch = {}
    for k, t in input_specs(cfg, ShapeConfig("t", PREFILL, 1,
                                             "prefill")).items():
        batch[k] = (torch.from_numpy(rng.integers(
            0, cfg.vocab_size, tuple(t.shape)).astype(np.int32)).to(dev)
            if not t.is_floating_point() else
            torch.randn(tuple(t.shape), generator=gen,
                        device=dev).to(t.dtype))
    full = make_serve_step(model, head="full")
    l2s = make_serve_step(model, head="l2s")
    prefill = make_prefill_step(model)
    steps = {"decode full": lambda: full(params, cache, tok, pos),
             "decode l2s": lambda: l2s(params, v, cand, cache, tok, pos),
             "prefill": lambda: prefill(params, batch)}
    out = {"label": " ".join(argv), "arch": ARCH,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "batch": B,
           "cache": CACHE, "prefill_tokens": PREFILL,
           "torch": torch.__version__, "card": torch.cuda.get_device_name(0),
           "setup_s": time.perf_counter() - t0}
    with torch.no_grad():
        for name, fn in steps.items():
            out[f"{name} ms"] = timed(torch.cuda.synchronize, fn,
                                      STEPS) * 1e3
        try:
            from repro_torch.utils import shard  # noqa: F401
        except ImportError:
            shard = None
        if shard is not None:
            out["check us a call"] = check_costs(torch, cfg.d_model, dev)
            out["shard.py calls, decode l2s"] = shard_calls(steps["decode l2s"])
            out["shard.py calls, prefill"] = shard_calls(steps["prefill"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
