"""Nested dicts of tensors walked in the reference's leaf order.

``jax.tree`` visits a dict's keys sorted; the port's parameter, gradient
and optimizer trees are plain nested dicts (and an ``AdamWState``), so
these helpers walk them in that order. Everything the port sums over
leaves (the gradient norm) sums in this order, so its float32 rounding
follows the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on each leaf of ``tree`` (a nested dict), with the
    subtrees of ``rest`` at the same paths as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_zip(tree, *rest) -> Iterator[Tuple]:
    """``(leaf, *subtrees of rest at its path)`` for each leaf of
    ``tree``, keys sorted (the reference's ``flatten_up_to``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_zip(tree[k], *(r[k] for r in rest))
    else:
        yield (tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict, keys sorted."""
    return [leaf for leaf, in tree_zip(tree)]


def tree_unflatten(like, leaves) -> Any:
    """A nested dict shaped like ``like`` whose leaves, in sorted-key
    order, are ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)
