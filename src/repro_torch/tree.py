"""Nested-dict trees of tensors (the parameter, gradient and optimizer
state trees): leaves in sorted-key order, the order in which
``jax.tree.leaves`` reads a dict."""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Sequence, Tuple

__all__ = ["tree_flatten_with_paths", "tree_leaves", "tree_map", "tree_unflatten"]


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_flatten_with_paths(tree: Any, prefix: Tuple[str, ...] = ()
                            ) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` in :func:`tree_leaves` order, the path being the
    dict keys joined by ``/``: the keys the JAX package's checkpoints
    give ``jax.tree_util.tree_flatten_with_path``'s paths."""
    if isinstance(tree, Mapping):
        return [kv for k in sorted(tree)
                for kv in tree_flatten_with_paths(tree[k], prefix + (str(k),))]
    return [("/".join(prefix), tree)]


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in
    :func:`tree_leaves` order, by ``leaves``."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    out = walk(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over ``tree``'s leaves and the nodes at the same paths of
    ``rest``, which may be deeper than ``tree`` (a leaf of ``tree`` meets
    a whole subtree there, as ``flatten_up_to`` gives it in JAX)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)
