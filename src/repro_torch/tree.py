"""Nested dict / list / tuple trees of tensors (params and decode caches)."""
from __future__ import annotations


def tree_map(fn, tree):
    """The same tree with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """Every leaf of the tree, depth first."""
    out = []
    tree_map(out.append, tree)
    return out
