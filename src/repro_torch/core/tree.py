"""Nested dict/tuple/list containers of tensors (the port's pytrees).

Parameters and pool state keep the reference's pytree shapes: dicts keyed
like the JAX trees, with a tuple of per-sublayer dicts under each
``seg{i}``.  Two helpers walk them in insertion order; a third lists the
leaves with their paths in the order (and spelling) of JAX's own flatten,
for the checkpoints and the optimizer's norm.
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


def tree_flatten_with_path(tree, prefix: str = ""):
    """``[(path, leaf)]`` in the order JAX flattens the same pytree (dict
    keys sorted, tuple and list items by index, a NamedTuple's fields as
    ``.name``), each path spelled as the reference's checkpoints spell
    it: the keys joined by ``/`` (``seg0/0/attn/wq``, ``.mu/embed``)."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_flatten_with_path(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in tree_flatten_with_path(getattr(tree, f),
                                                 join(f".{f}"))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_flatten_with_path(v, join(i))]
    return [(prefix, tree)]


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """Apply ``fn(path, leaf)`` leafwise, the paths spelled as in
    :func:`tree_flatten_with_path`; the result keeps ``tree``'s shape."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f),
                                               join(f".{f}"))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
