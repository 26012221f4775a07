"""Error-feedback int8 gradient compression; port of
`repro.distributed.compression`.

``ErrorFeedback`` quantizes the gradient tree to int8 per leaf before the
optimizer and carries the quantization residual in the train state, so the
compression error does not bias the trajectory (Seide et al.). The scale
stays in f32, and `torch.round` rounds half to even as `jnp.round` does.

``int8_psum`` is the quantized all-reduce the JAX package runs under
``shard_map``, here over a mesh axis's ranks (`launch.mesh.Mesh`): each
leaf scaled to int8 by the largest per-rank scale (a max-reduce), summed
in int32 and rescaled. Every step is exact or IEEE-identical (a max, an
integer sum, the same division, round half to even), so it equals the JAX
one bit for bit.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import tree as tree_lib


def _scale(amax):
    """The int8 scale of a leaf whose largest magnitude is ``amax``."""
    return torch.clamp(amax, min=1e-12) / 127.0


def _quant_int8(x, scale=None):
    """``x`` as int8 under ``scale`` (default: its own, `_scale` of its
    largest magnitude); returns (int8, scale)."""
    if scale is None:
        scale = _scale(torch.max(torch.abs(x)))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_psum(tree, axis_name: str, mesh):
    """Quantized sum of ``tree`` over the ranks along ``axis_name`` of
    ``mesh`` (collective): int8 payload, int32 sum, f32 result."""
    def one(x):
        x32 = x.float()
        # max-scale across ranks so dequantization is consistent
        scale = mesh.all_reduce(_scale(torch.max(torch.abs(x32))), axis_name,
                                "max")
        q, _ = _quant_int8(x32, scale)
        total = mesh.all_reduce(q.to(torch.int32), axis_name, "sum")
        return total.float() * scale
    return tree_lib.map(one, tree)


class ErrorFeedback(NamedTuple):
    residual: Any


def error_feedback_init(params) -> ErrorFeedback:
    return ErrorFeedback(residual=tree_lib.map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def compress_grads(grads, ef: ErrorFeedback, reduce_max=None):
    """int8 quantize-dequantize with residual carry (error feedback).
    Returns (dequantized grads, ErrorFeedback). Each leaf's scale is its
    largest magnitude; where the leaves are pieces of sharded arrays,
    ``reduce_max`` maps the list of per-piece maxima to the whole leaves'
    (the max-reduce GSPMD runs for the JAX step)."""
    g32s = [g.float() + r for g, r in zip(tree_lib.leaves(grads),
                                          tree_lib.leaves(ef.residual))]
    amax = [torch.max(torch.abs(x)) for x in g32s]
    if reduce_max is not None:
        amax = reduce_max(amax)

    def one(g32, m):
        q, scale = _quant_int8(g32, _scale(m))
        deq = q.float() * scale
        return deq, g32 - deq

    out = [one(g32, m) for g32, m in zip(g32s, amax)]
    return (tree_lib.unflatten(grads, [o[0] for o in out]),
            ErrorFeedback(residual=tree_lib.unflatten(grads,
                                                      [o[1] for o in out])))


__all__ = ["ErrorFeedback", "compress_grads", "error_feedback_init",
           "int8_psum"]
