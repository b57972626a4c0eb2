"""Paths and leaves of the port's parameter trees (dicts, lists, tuples).

Leaves come in ``jax.tree_util``'s order: dict keys sorted, lists and
tuples in order.  A path is the tuple of dict keys and list/tuple indices
from the root to a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def leaves_with_paths(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) of every leaf, in jax order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in leaves_with_paths(t, prefix + (i,))]
    return [(prefix, tree)]


def at(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def map_params(fn: Callable, tree, *others, prefix: Path = ()):
    """``fn(leaf, *others' entries at its path)`` over ``tree``'s leaves,
    as a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v, *others, prefix=prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_params(fn, v, *others, prefix=prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(tree, *(at(o, prefix) for o in others))
