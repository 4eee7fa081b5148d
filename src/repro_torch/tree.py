"""Nested dict / list / tuple trees of tensors (params, optimiser states and
decode caches)."""
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


def tree_flatten(tree) -> list:
    """Every leaf in ``jax.tree_util``'s order: dict keys sorted, lists and
    tuples (NamedTuples by field) in order. The reference's pytrees flatten
    the same way, so the i-th leaf here is the reference's i-th leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_flatten(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """``template``'s structure with its leaves replaced, in
    ``tree_flatten``'s order, by ``leaves`` (as many as it has)."""
    leaves = list(leaves)
    n = len(tree_flatten(template))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a template of {n}")
    return _fill(template, iter(leaves))


def _fill(tmpl, it):
    # a module-level function, not a closure that calls itself: such a
    # closure is a reference cycle that keeps ``it``, and so every leaf,
    # alive until the garbage collector runs (at full width, gigabytes of
    # device memory held after the tree is dropped)
    if isinstance(tmpl, dict):
        filled = {k: _fill(tmpl[k], it) for k in sorted(tmpl)}
        return {k: filled[k] for k in tmpl}
    if isinstance(tmpl, tuple) and hasattr(tmpl, "_fields"):
        return type(tmpl)(*(_fill(v, it) for v in tmpl))
    if isinstance(tmpl, (list, tuple)):
        return type(tmpl)(_fill(v, it) for v in tmpl)
    return next(it)
