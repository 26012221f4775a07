"""Nested containers of tensors in the JAX package's pytree order.

The training state is the JAX pytree as plain Python containers: dicts,
NamedTuples (`TrainState`, `AdamWState`, `ErrorFeedback`) and None. JAX
flattens a dict by its sorted keys, a NamedTuple in field order, and None
as a node without leaves. The optimizer sums its global norm over the
leaves in that order, and a checkpoint numbers its arrays in it, so the
port flattens the same way.

A leaf crosses to the host and back (`leaf_to_numpy`, `leaf_from_numpy`)
bit for bit in every dtype, bf16 included, with numpy alone: numpy has no
bfloat16 of its own, so a bf16 leaf travels as its 16-bit patterns.
"""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

# numpy's record of a bfloat16 array written to an ``.npy`` (the dtype of
# `ml_dtypes`, which JAX uses, is not one numpy can name): raw 2-byte records
BF16_RECORD = np.dtype("V2")


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


def leaf_to_numpy(t) -> np.ndarray:
    """A host copy of ``t`` (a tensor, or anything numpy takes) as a numpy
    array; a bf16 tensor as its 2-byte records (`BF16_RECORD`), what numpy
    writes for a JAX bfloat16 array."""
    if not torch.is_tensor(t):
        return np.array(t, copy=True)
    host = t.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(BF16_RECORD)
    return host.numpy()


def dtype_name(t) -> str:
    """The dtype's name as the JAX package writes it (``"bfloat16"``,
    ``"float32"``, ...), for a tensor or a numpy / JAX array."""
    if torch.is_tensor(t):
        return str(t.dtype).replace("torch.", "")
    return str(np.dtype(t.dtype))


def leaf_from_numpy(arr, dtype_hint: str = "", copy: bool = True) -> torch.Tensor:
    """A CPU tensor holding ``arr`` bit for bit (a copy unless ``copy`` is
    False and ``arr`` is a writable numpy array the tensor may share): an
    array whose dtype is named ``bfloat16`` (JAX's, from `ml_dtypes`), or
    raw 2-byte records with ``dtype_hint`` ``"bfloat16"`` (a checkpoint's
    leaf), becomes a bf16 tensor of the same 16-bit patterns."""
    arr = np.array(arr, copy=True) if copy else np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    if arr.dtype.name == "bfloat16" or (arr.dtype == BF16_RECORD
                                        and dtype_hint == "bfloat16"):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)
