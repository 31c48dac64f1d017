"""Minimal pytree helpers for nested lists, tuples and dicts of tensors.

The JAX package carries model params as pytrees (a list of ``{"w", "b"}``
dicts per MLP) and maps over them with ``jax.tree``; these helpers do the
same for the port's tensors. Dict leaves are visited in insertion order
(``tree_leaves_sorted``: in JAX's sorted-key order).
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in traversal order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_leaves_sorted(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order: dict keys
    sorted at every level. A sum over leaves in this order rounds as the
    JAX package's does."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves_sorted(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves_sorted(v)]
    return [tree]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """Rebuild ``template``'s structure from ``leaves`` (traversal order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def unstack(tree: Any) -> List[Any]:
    """The per-layer trees of a tree whose leaves are stacked on axis 0, as
    views (``unbind``). Under autograd the backward stacks the per-layer
    gradients once per leaf, where indexing each layer (``t[i]``) would
    make and add a zero gradient of the whole stack per layer; the values
    are the same."""
    cols = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [c[i] for c in cols]) for i in range(len(cols[0]))]
