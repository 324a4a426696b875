"""Tree helpers over the port's parameter trees (port of the pytree helpers
of `repro.common`): nested dicts whose leaves are tensors. Anything that is
not a dict is a leaf, so a bare tensor is a one-leaf tree. The package
imports no torch: the dist workers import `repro_torch.common.topologies`
and must not pay for it."""
from __future__ import annotations

import operator
from typing import Callable, List


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest` (trees
    of the same structure); the result has `tree`'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """The leaves in tree_map's order (dict insertion order, depth first)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of `like`'s structure holding `leaves` (tree_leaves' order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_add(a, b):
    return tree_map(operator.add, a, b)
