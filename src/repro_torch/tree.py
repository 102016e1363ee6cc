"""Trees of tensors: the port's stand-in for ``jax.tree``.

A tree is nested dicts and lists (a named tuple such as ``AdamWState``
too, for ``flatten``/``unflatten``); anything else is a leaf.  ``leaves``
and ``map_leaves`` treat a plain tuple as one leaf (an int8 AdamW moment
is a ``(codes, scale)`` pair in a tensor's place); ``flatten`` opens
tuples too and names each leaf by its path as ``jax.tree_util.keystr``
writes it (``['params']['embed']``, ``[3]``, ``.m``), the checkpoint
layout of both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, in its order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the entries of the trees in
    ``rest`` at the same places (whatever they hold there)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf, tuples opened, paths written as
    ``jax.tree_util.keystr`` writes them."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in flatten(v, f"{prefix}['{k}']")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for k, v in zip(tree._fields, tree)
                for x in flatten(v, f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def unflatten(like: Any, new_leaves: Iterator[Any]) -> Any:
    """``like``'s structure (as ``flatten`` walks it) with its leaves
    taken from ``new_leaves`` in order."""
    if isinstance(like, dict):
        return {k: unflatten(v, new_leaves) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(unflatten(v, new_leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(v, new_leaves) for v in like)
    return next(new_leaves)
