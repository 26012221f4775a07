"""Nested containers of tensors in the JAX package's pytree order.

The training state is the JAX pytree as plain Python containers: dicts,
NamedTuples (`TrainState`, `AdamWState`, `ErrorFeedback`) and None. JAX
flattens a dict by its sorted keys, a NamedTuple in field order, and None
as a node without leaves. The optimizer sums its global norm over the
leaves in that order, and a checkpoint numbers its arrays in it, so the
port flattens the same way.
"""
from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in JAX flatten order."""
    out: List[Any] = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])
        elif _is_namedtuple(node):
            for child in node:
                walk(child)
        else:
            out.append(node)

    walk(tree)
    return out


def unflatten(tree, values) -> Any:
    """``tree``'s structure with its leaves replaced, in flatten order, by
    ``values``."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(child) for child in node))
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def map(fn: Callable, tree, *rest) -> Any:   # noqa: A001 - jax.tree.map
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for these containers:
    what a JAX checkpoint's manifest records."""

    def desc(node):
        if node is None:
            return "None"
        if isinstance(node, dict):
            inner = ", ".join(f"{key!r}: {desc(node[key])}"
                              for key in sorted(node))
            return "{" + inner + "}"
        if _is_namedtuple(node):
            inner = ", ".join(desc(child) for child in node)
            return f"CustomNode(namedtuple[{type(node).__name__}], [{inner}])"
        return "*"

    return f"PyTreeDef({desc(tree)})"


__all__ = ["leaves", "map", "treedef_str", "unflatten"]
