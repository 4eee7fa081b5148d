"""Small tree helpers used across the framework. Twin of
``repro/utils/pytree.py``, over ``repro_torch/tree.py``'s walkers (nested
dicts, lists, tuples and NamedTuples of tensors, e.g. an ``AdamWState``)."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_flatten, tree_unflatten


def tree_size(tree) -> int:
    """Total number of parameters in a tree."""
    return int(sum(x.numel() for x in tree_flatten(tree)))


def tree_bytes(tree) -> int:
    """Total bytes of a tree (by dtype itemsize); meta tensors count their
    shapes, as the reference counts ``ShapeDtypeStruct`` leaves."""
    return int(sum(x.numel() * x.element_size() for x in tree_flatten(tree)))


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm of a tree, each leaf squared and summed in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_flatten(tree)))


def cast_tree(tree, dtype):
    """Cast all floating-point leaves of a tree to ``dtype``."""
    return tree_unflatten(tree, [x.to(dtype) if x.is_floating_point() else x
                                 for x in tree_flatten(tree)])
