"""Nested dicts of tensors, the port's parameter and optimizer trees.

The reference keeps its state in JAX pytrees; the port keeps the same
nesting as plain dicts and lists (the LM's per-period-position layers).
Leaves are visited in sorted-key order for a dict and in order for a list,
the order ``jax.tree_util`` flattens them in. A tuple is a leaf.
"""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (which share its structure), as a new tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, sub, *(r[i] for r in rest)) for i, sub in enumerate(tree)]
    return fn(tree, *rest)
