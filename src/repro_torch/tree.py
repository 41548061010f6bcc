"""Nested dicts of tensors, the port's parameter and optimizer trees.

The reference keeps its state in JAX pytrees; the port keeps the same
nesting as plain dicts. Leaves are visited in sorted-key order, the order
``jax.tree_util`` flattens a dict in.
"""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (which share its structure), as a new tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)
