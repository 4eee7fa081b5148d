"""Sharding rules: param / activation / cache partition specs per
architecture, and their DTensor placements on a mesh. Twin of
``repro/launch/sharding.py``.

The rules are the reference's, line for line (Megatron-style baseline):
  * vocab dim of embedding / LM head → "model"
  * attention heads → "model" when the head axis divides it, else
    replicated (never head_dim)
  * MLP ff dim → "model" (column ∥ up/gate, row ∥ down)
  * MoE experts: tensor-parallel inside experts (ff → "model"), or
    expert-parallel (E → "model") when ``expert_parallel`` and the experts
    divide the model axis (phi3.5: 16 experts on 16)
  * Mamba2: inner channels / heads → "model"
  * batch → ("pod", "data"); long_500k (batch = 1) shards the cache's
    sequence instead
  * FSDP (``_augment_fsdp``): "data" on the largest still-unsharded dim of
    at least 512 that it divides, never the stacked layer axis
Rules are divisibility-checked against the mesh.

A spec has a ``PartitionSpec``'s meaning: one entry per tensor dim, each
None (replicated), an axis name, or a tuple of axis names (the dim split
over their product, the first the outermost). ``placements(spec, mesh)``
(in ``utils/shard.py``, whose pins take specs too) turns it into DTensor
placements, one per MESH dim: mesh dim i is ``Shard(d)`` when axis i
names tensor dim d, else ``Replicate()``. A dim
over ("pod", "data") is ``Shard(d)`` on both mesh dims, in mesh order,
which splits it as GSPMD does (pod outer, data inner). ``NamedSharding``
pairs a mesh with a spec, as the reference's does; ``distribute`` puts a
tree of meta tensors on the mesh at those placements, each device's shard
``spec``'s local shape.

Where the reference reads ``REPRO_BASELINE_CACHE`` from the environment,
``cache_shardings`` takes ``baseline_cache``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import data_axes, mesh_axis_sizes
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.utils.shard import local_shape, placements

Spec = Tuple[Any, ...]


def _divisible(n: int, size: int) -> bool:
    return n % size == 0


def param_spec(path: str, shape: tuple, cfg: ModelConfig, msize: int,
               expert_parallel: bool = False) -> Spec:
    """The spec of one param given its path ("stack/blocks/attn/wq") and
    shape."""
    none = (None,) * len(shape)

    def at(axis: int, name: str = "model") -> Spec:
        spec = list(none)
        spec[axis] = name
        return tuple(spec)

    def last_at(axis: int) -> Spec:
        return at(axis) if _divisible(shape[axis], msize) else none

    last = path.split("/")[-1]
    # embeddings / head: vocab axis → model
    if last in ("embedding", "lm_head", "lm_bias"):
        return last_at(0)

    # attention (stacked: a leading L axis for blocks, none for shared):
    # shard the heads axis when it divides, else replicate (never head_dim)
    off = 1 if path.startswith("stack/blocks") else 0
    if "attn" in path:
        if last in ("wq", "wk", "wv"):       # (d, H or KV, hd)
            return last_at(off + 1)
        if last in ("wo", "bq", "bk", "bv"):  # (H, hd, d), (H or KV, hd)
            return last_at(off)

    # MoE stacked experts: (L, E, d, ff) or (L, E, ff, d); router (L, d, E)
    if "moe" in path:
        if last == "w_router":
            return none
        if expert_parallel and _divisible(shape[off], msize):
            return at(off)
        if last in ("w_gate", "w_up"):
            return last_at(len(shape) - 1)
        if last == "w_down":
            return last_at(len(shape) - 2)

    # dense MLP: (L?, d, ff) / (L?, ff, d)
    if "mlp" in path:
        if last in ("w_gate", "w_up"):
            return last_at(len(shape) - 1)
        if last == "w_down":
            return last_at(len(shape) - 2)

    # Mamba2 / SSD
    if "ssm" in path:
        if last in ("in_proj", "conv_w", "conv_b", "norm_scale", "A_log",
                    "D", "dt_bias"):
            return last_at(len(shape) - 1)
        if last == "out_proj":                # (L?, dinner, d)
            return last_at(len(shape) - 2)

    # LSTM: (d, 4d) and (4d,): the gate dim
    if "lstm" in path and last in ("wx", "wh", "b"):
        return last_at(len(shape) - 1)

    if last in ("vision_proj", "frame_proj"):
        return last_at(1)

    # norms and everything else: replicated
    return none


def _augment_fsdp(spec: Spec, path: str, shape: tuple, dsize: int,
                  min_dim: int = 512) -> Spec:
    """"data" on the largest still-unsharded dim of at least ``min_dim``
    that ``dsize`` divides (MaxText-style FSDP: the large configs' weights
    do not fit 16-way tensor parallelism alone). The stacked layer axis
    (axis 0 of stack/blocks params) is never sharded."""
    spec_l = list(spec) + [None] * (len(shape) - len(spec))
    start = 1 if path.startswith("stack/blocks") else 0
    best, best_ax = 0, None
    for ax in range(start, len(shape)):
        if spec_l[ax] is not None:
            continue
        if shape[ax] >= min_dim and shape[ax] % dsize == 0 and shape[ax] > best:
            best, best_ax = shape[ax], ax
    if best_ax is not None:
        spec_l[best_ax] = "data"
    return tuple(spec_l)


# -- specs on a mesh -------------------------------------------------------------


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def distribute(tree, shardings):
    """Each leaf of ``tree`` as a DTensor on its sharding's mesh, its local
    tensor this device's shard: on the meta device an empty tensor of the
    shard's shape (nothing allocated and nothing sent), elsewhere a copy of
    the slice this process's coordinate holds. ``shardings`` mirrors
    ``tree``."""
    from torch.distributed.tensor import DTensor, Shard

    def one(t, sh):
        pl = sh.placements
        if t.device.type == "meta":
            loc = torch.empty(local_shape(t.shape, sh.spec, sh.mesh),
                              dtype=t.dtype, device=t.device)
        else:
            loc, coord = t, sh.mesh.get_coordinate()
            for i, p in enumerate(pl):      # mesh order: outer to inner
                if isinstance(p, Shard):
                    loc = loc.chunk(sh.mesh.size(i), p.dim)[coord[i]]
            loc = loc.contiguous()
        return DTensor.from_local(loc, sh.mesh, pl, run_check=False,
                                  shape=t.shape,
                                  stride=_contiguous_stride(t.shape))
    return tree_unflatten(tree, [one(t, sh) for t, sh in
                                 zip(tree_flatten(tree),
                                     tree_flatten(shardings))])


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _map_paths(fn, tree, prefix=""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_paths(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


# -- tree rules -------------------------------------------------------------------


def params_shardings(mesh, cfg: ModelConfig, abstract_params,
                     expert_parallel: bool = False, fsdp: bool = True):
    """Tree of ``NamedSharding``s matching a params tree."""
    sizes = mesh_axis_sizes(mesh)
    msize = sizes.get("model", 1)
    dsize = sizes.get("data", 1)

    def f(path, leaf):
        spec = param_spec(path, tuple(leaf.shape), cfg, msize,
                          expert_parallel)
        if fsdp:
            spec = _augment_fsdp(spec, path, tuple(leaf.shape), dsize)
        return NamedSharding(mesh, spec)
    return _map_paths(f, abstract_params)


def _dsize(mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


def batch_shardings(mesh, cfg: ModelConfig, abstract_batch):
    """Inputs: the batch axis over (pod, data) when it divides, else
    replicated."""
    daxes, dsize = data_axes(mesh), _dsize(mesh)

    def f(path, leaf):
        if leaf.dim() >= 1 and leaf.shape[0] % dsize == 0 and \
                leaf.shape[0] > 1:
            return NamedSharding(mesh, (daxes,))
        return NamedSharding(mesh, ())
    return _map_paths(f, abstract_batch)


def cache_shardings(mesh, cfg: ModelConfig, abstract_cache,
                    force_seq_shard: bool = False,
                    baseline_cache: bool = False):
    """Decode caches, stacked (L, B, ...): the batch → data when it
    divides, else the attention SEQUENCE dim → data (long-context sequence
    parallelism, batch = 1); kv-heads / ssm heads / channels → model when
    they divide. A K/V cache of at most 8,192 slots (a sliding-window ring)
    keeps the simple layout, head_dim → model as a last resort, unless
    ``force_seq_shard`` (the weight-stationary ``serve_2d`` decode) or
    ``baseline_cache`` (every cache in the simple layout) says otherwise."""
    sizes = mesh_axis_sizes(mesh)
    msize = sizes.get("model", 1)
    daxes, dsize = data_axes(mesh), _dsize(mesh)

    def f(path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        # (L, B, S, KV, hd) attention, (n_super, B, S, KV, hd) shared
        if path.endswith("/k") or path.endswith("/v") or "attn" in path:
            if len(shape) == 5:
                _, B, S, KV, hd = shape
                if (S <= 8192 or baseline_cache) and not force_seq_shard:
                    if B % dsize == 0 and B > 1:
                        spec[1] = daxes
                    if KV % msize == 0:
                        spec[3] = "model"
                    elif hd % msize == 0:
                        spec[4] = "model"
                    return NamedSharding(mesh, tuple(spec))
                seq_axes = []
                if B % dsize == 0 and B > 1 and not force_seq_shard:
                    spec[1] = daxes
                else:
                    seq_axes.extend(daxes)
                if KV % msize == 0:
                    spec[3] = "model"
                else:
                    seq_axes.append("model")
                if seq_axes:
                    ssize = math.prod(sizes[a] for a in seq_axes)
                    if S % ssize == 0:
                        spec[2] = tuple(seq_axes) if len(seq_axes) > 1 \
                            else seq_axes[0]
                return NamedSharding(mesh, tuple(spec))
        if "state" in path and len(shape) == 5:     # (L, B, H, P, N)
            _, B, H, _, _ = shape
            if B % dsize == 0 and B > 1:
                spec[1] = daxes
            if H % msize == 0:
                spec[2] = "model"
            return NamedSharding(mesh, tuple(spec))
        if "conv_tail" in path and len(shape) == 4:  # (L, B, W-1, C)
            _, B, _, C = shape
            if B % dsize == 0 and B > 1:
                spec[1] = daxes
            if C % msize == 0:
                spec[3] = "model"
            return NamedSharding(mesh, tuple(spec))
        if len(shape) == 2:                          # lstm state (B, d)
            B, d = shape
            if B % dsize == 0 and B > 1:
                spec[0] = daxes
            if d % msize == 0:
                spec[1] = "model"
            return NamedSharding(mesh, tuple(spec))
        return NamedSharding(mesh, ())
    return _map_paths(f, abstract_cache)


def vocab_sharded(mesh, ndim: int, axis: int = 0) -> NamedSharding:
    """``axis`` of an ndim-tensor over "model": the vocab-axis rule of the
    sharded softmax heads."""
    spec = [None] * ndim
    spec[axis] = "model"
    return NamedSharding(mesh, tuple(spec))


def head_shardings(mesh) -> dict:
    """A vocab-sharded head (``heads/sharded.py``): W (L, d) and b (L,)
    row-partitioned over "model", the routing weights and queries
    replicated, the per-shard candidate tables (n_shards, r, C) on their
    leading shard axis."""
    return {"W": vocab_sharded(mesh, 2), "b": vocab_sharded(mesh, 1),
            "cand": vocab_sharded(mesh, 3),
            "replicated": NamedSharding(mesh, ())}


def adaptive_head_shardings(mesh) -> dict:
    """The adaptive head (``heads/adaptive.py``): the short-list tier's
    tiles, the tail gates and the id maps replicated; the rare tail's
    W (n·Ls_t, d), b and per-shard (n, C, kb) block tables row-partitioned
    over "model", as the fully sharded heads."""
    return {"tail_W": vocab_sharded(mesh, 2),
            "tail_b": vocab_sharded(mesh, 1),
            "tail_cand": vocab_sharded(mesh, 3),
            "replicated": NamedSharding(mesh, ())}


def screen_shardings(mesh, abstract_screen):
    """The L2S screen (v (r, d), cand_blocks (r, K)) is small: replicated."""
    return replicated(mesh, abstract_screen)


def replicated(mesh, tree):
    return tree_map(lambda _: NamedSharding(mesh, ()), tree)
