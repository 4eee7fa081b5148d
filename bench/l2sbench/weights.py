"""Weights and the screen, drawn from the seed on the card by the
benchmark's own code.

A configuration's reference module (``bench/reference/<family>.py``)
declares every weight: ``param_spec(cfg)`` → [(path, shape, dtype, rule)].
``make_weights`` draws them with one ``torch.Generator`` on the device, in
one ``randn`` call per dtype and one ``rand`` call for the uniform draws,
and carves the leaves out of those buffers (each leaf 64-element aligned,
so every leaf is a 16-byte aligned contiguous tensor). The same seed on
the same device gives the same bits, so the reference draws its own copy
after the program's run, and shares nothing the program held.

Rules: ``("normal", std)``, ``("zeros",)``, ``("ones",)``,
``("forget_bias", d)`` (an LSTM gate bias: 1 on the forget gate's d
entries), ``("a_log",)`` (log of 1..16 spread over the last axis, Mamba2's
A), ``("dt_bias", lo, hi)`` (the inverse softplus of a step drawn
log-uniform in [lo, hi], Mamba2's convention).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ALIGN = 64

Path = Tuple


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def make_weights(spec: List[tuple], seed: int,
                 device) -> Dict[Path, torch.Tensor]:
    """{path: tensor} for every leaf of ``spec``, drawn from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2**63 - 1))
    normal: Dict[str, int] = {}
    n_uniform = 0
    offsets = {}
    for path, shape, dtype, rule in spec:
        n = math.prod(shape)
        if rule[0] == "normal":
            off = normal.get(dtype, 0)
            offsets[path] = off
            normal[dtype] = off + -(-n // ALIGN) * ALIGN
        elif rule[0] == "dt_bias":
            offsets[path] = n_uniform
            n_uniform += n
    bufs = {dt: torch.randn((n,), generator=g, device=device,
                            dtype=_dtype(dt))
            for dt, n in sorted(normal.items())}
    uni = torch.rand((max(n_uniform, 1),), generator=g, device=device)
    out = {}
    for path, shape, dtype, rule in spec:
        n = math.prod(shape)
        kind = rule[0]
        if kind == "normal":
            off = offsets[path]
            t = bufs[dtype][off:off + n].view(shape).mul_(rule[1])
        elif kind == "zeros":
            t = torch.zeros(shape, dtype=_dtype(dtype), device=device)
        elif kind == "ones":
            t = torch.ones(shape, dtype=_dtype(dtype), device=device)
        elif kind == "forget_bias":
            t = torch.zeros(shape, dtype=_dtype(dtype), device=device)
            t[..., rule[1]:2 * rule[1]] = 1.0
        elif kind == "a_log":
            H = shape[-1]
            t = torch.log(torch.linspace(1.0, 16.0, H, device=device)) \
                .expand(shape).to(_dtype(dtype)).contiguous()
        elif kind == "dt_bias":
            lo, hi = math.log(rule[1]), math.log(rule[2])
            u = uni[offsets[path]:offsets[path] + n].view(shape)
            dt0 = torch.exp(u * (hi - lo) + lo)
            t = (dt0 + torch.log(-torch.expm1(-dt0))).to(_dtype(dtype))
        else:
            raise ValueError(f"{path}: unknown weight rule {rule!r}")
        out[path] = t
    return out


def as_tree(flat: Dict[Path, torch.Tensor]):
    """{path: tensor} → the nested dicts (and lists, for integer keys) the
    program's params are."""
    root: dict = {}
    for path, t in flat.items():
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            if key not in node:
                node[key] = {}
            node = node[key]
        node[path[-1]] = t
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def flatten(tree, prefix: Path = ()) -> Dict[Path, object]:
    """The program's nested params → {path: leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, prefix + (k,)))
    return out


def check_layout(flat: Dict[Path, torch.Tensor], program_meta) -> None:
    """Raise unless the program's params (its ``Model.init`` on the meta
    device) have exactly the paths, shapes and dtypes the reference
    declares: the benchmark's weights then mean to the program what they
    mean to the reference."""
    want = {p: (tuple(t.shape), t.dtype) for p, t in flat.items()}
    have = {p: (tuple(t.shape), t.dtype)
            for p, t in flatten(program_meta).items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()), key=str)[:8]
        raise ValueError(f"the program's parameter layout differs from the "
                         f"reference's: {diff}")


def make_screen(cfg: dict, seed: int, device):
    """The cell's L2S screen from the seed: ``clusters`` random centroids
    v (r, d) float32 and, per cluster, ``blocks_per_cluster`` distinct
    random 128-word blocks of the vocabulary → (v, cand (r, K) int32)."""
    sc = cfg["screen"]
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7 + 3) & (2**63 - 1))
    r, K, blk = int(sc["clusters"]), int(sc["blocks_per_cluster"]), \
        int(sc["block"])
    d, V = int(cfg["d_model"]), int(cfg["vocab_size"])
    n_blk = -(-V // blk)
    v = torch.randn((r, d), generator=g, device=device) / math.sqrt(d)
    order = torch.rand((r, n_blk), generator=g, device=device).argsort(dim=1)
    cand = order[:, :K].sort(dim=1).values.to(torch.int32).contiguous()
    return v, cand
