"""Nested-dict parameter trees: flatten and rebuild in a fixed leaf order.

A tree is a dict whose values are tensors (leaves) or dicts (subtrees);
an empty dict is a subtree with no leaves (the non-parametric norms). Leaves
come out in sorted-key order, depth first — the order in which
``jax.tree_util.tree_flatten`` visits a dict pytree — so a flat panel of the
port lines up column for column with a panel of the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves in sorted-key order, skeleton). The skeleton is the tree with
    every leaf replaced by None; :func:`tree_unflatten` refills it."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        leaves.append(t)
        return None

    return leaves, walk(tree)


def tree_unflatten(skeleton, leaves) -> Dict:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def fill(s):
        if isinstance(s, dict):
            return {k: fill(s[k]) for k in sorted(s)}
        return next(it)

    out = fill(skeleton)
    if next(it, None) is not None:
        raise ValueError("more leaves than the skeleton has slots")
    return out


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf, keeping the structure."""
    leaves, skel = tree_flatten(tree)
    return tree_unflatten(skel, [fn(x) for x in leaves])


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]
