"""Nested dict/tuple/list containers of tensors (the port's pytrees).

Parameters and pool state keep the reference's pytree shapes: dicts keyed
like the JAX trees, with a tuple of per-sublayer dicts under each
``seg{i}``.  These two helpers are all the tree handling the port needs.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` (and same-shaped ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """Leaves in the order :func:`tree_map` visits them."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out
