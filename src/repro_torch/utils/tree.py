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
    return leaves, _flatten_into(tree, leaves)


def tree_unflatten(skeleton, leaves) -> Dict:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)
    out = _fill(skeleton, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the skeleton has slots")
    return out


# The walks are module functions, not closures: a recursive closure is a
# reference cycle (function -> cell -> function) that would keep the leaves
# (whole parameter panels, on the card) alive until Python's cyclic
# collector happens to run.
def _flatten_into(t, leaves):
    if isinstance(t, dict):
        return {k: _flatten_into(t[k], leaves) for k in sorted(t)}
    leaves.append(t)
    return None


def _fill(s, it):
    if isinstance(s, dict):
        return {k: _fill(s[k], it) for k in sorted(s)}
    return next(it)


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf, keeping the structure."""
    leaves, skel = tree_flatten(tree)
    return tree_unflatten(skel, [fn(x) for x in leaves])


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]
