"""Trees of tensors, the port's counterpart of ``jax.tree``.

Parameter, gradient and optimizer-state trees are nested dicts with
tensor leaves; train states are dataclasses of such trees.  The leaves
come in the order in which JAX flattens the same tree: dict keys sorted,
dataclass fields in declaration order, so leaf lists line up with the
JAX package's."""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over dict trees of one structure.  A
    tree in ``rest`` may go deeper than ``tree``: ``fn`` then receives
    its subtree where ``tree`` has a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path: str = "") -> list:
    """(path, leaf) of every leaf: ``/key`` for dict entries, ``.field``
    for dataclass fields."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_with_path(tree[k], f"{path}/{k}")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves_with_path(getattr(tree, f.name),
                                               f"{path}.{f.name}")]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    """The leaves of a tree, in JAX's order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like, leaves: Iterable):
    """A tree of ``like``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        return next(it)

    return build(like)
