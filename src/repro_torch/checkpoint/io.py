"""Tree checkpointing: an npz tensor store plus JSON metadata. Twin of
``repro/checkpoint/io.py``.

Layout:  <dir>/step_<N>/arrays.npz  +  <dir>/step_<N>/meta.json

Leaves are stored as ``a0, a1, ...`` in ``jax.tree_util``'s order (dict keys
sorted; ``repro_torch.tree.tree_flatten``), so the reference's
``arrays.npz`` of the same tree loads into the port's template and the
converse. The reference keeps its metadata in ``meta.msgpack``; the port
writes ``meta.json`` (the GPU machine has no ``msgpack``) and loads a
reference-written step's arrays with empty metadata.
Restore requires a template tree (same structure); shapes are validated on
load.
"""
from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    metadata: dict | None = None) -> str:
    """Write ``tree``'s leaves to ``<dir>/step_<N>/arrays.npz``, one leaf at
    a time (the file ``np.savez`` writes: an uncompressed zip of ``a<i>.npy``
    members), so host memory holds one leaf, not the whole tree: a float32
    zamba2-2.7b with its AdamW moments is 27.8 GB."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    leaves = tree_flatten(tree)
    with zipfile.ZipFile(os.path.join(path, "arrays.npz"), mode="w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, x in enumerate(leaves):
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array(
                    fid, torch.as_tensor(x).detach().cpu().numpy())
    meta = {"n_leaves": len(leaves), "step": step,
            "metadata": metadata or {}}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(ckpt_dir: str, template: Any,
                    step: Optional[int] = None) -> tuple:
    """→ (tree, metadata). ``template`` fixes the tree's structure; each
    leaf comes back as a tensor on the device of the template's leaf."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    meta = {}
    if os.path.exists(os.path.join(path, "meta.json")):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    leaves = tree_flatten(template)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        n = len(data.files)
        if meta.get("n_leaves", n) != n or n != len(leaves):
            raise ValueError(f"checkpoint has {n} leaves, template has "
                             f"{len(leaves)}")
        new_leaves = []
        for i, tmpl in enumerate(leaves):
            arr = data[f"a{i}"]
            is_t = isinstance(tmpl, torch.Tensor)
            shape = tuple(tmpl.shape) if is_t else np.shape(tmpl)
            if tuple(arr.shape) != shape:
                raise ValueError(f"leaf {i}: shape {arr.shape} != {shape}")
            dev = tmpl.device if is_t else "cpu"
            new_leaves.append(torch.from_numpy(arr).to(dev))
    return tree_unflatten(template, new_leaves), meta.get("metadata", {})


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)$", d))]
    return max(steps) if steps else None
