"""Nested-dict trees (the state layout of params, moments and logical
axes), flattened in sorted key order as `jax.tree` flattens dicts."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leafwise over trees of nested dicts with equal keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """Inverse of `tree_leaves` against a tree of the same structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
