"""Error-feedback int8 gradient compression; port of
`repro.distributed.compression`.

``ErrorFeedback`` quantizes the gradient tree to int8 per leaf before the
optimizer and carries the quantization residual in the train state, so the
compression error does not bias the trajectory (Seide et al.). The scale
stays in f32, and `torch.round` rounds half to even as `jnp.round` does.

``int8_psum``, the quantized all-reduce the JAX trainer runs under
``shard_map``, is a collective: it waits for the multi-card training slice
(ROADMAP Queue 1 item 17).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import tree as tree_lib


def _quant_int8(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_psum(tree, axis_name: str):
    raise NotImplementedError(
        "int8_psum is a collective across cards; it waits for the multi-card "
        "training slice (ROADMAP Queue 1 item 17)")


class ErrorFeedback(NamedTuple):
    residual: Any


def error_feedback_init(params) -> ErrorFeedback:
    return ErrorFeedback(residual=tree_lib.map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def compress_grads(grads, ef: ErrorFeedback):
    """int8 quantize-dequantize with residual carry (error feedback).
    Returns (dequantized grads, ErrorFeedback)."""
    def one(g, r):
        g32 = g.float() + r
        q, scale = _quant_int8(g32)
        deq = q.float() * scale
        return deq, g32 - deq

    out = [one(g, r) for g, r in zip(tree_lib.leaves(grads),
                                     tree_lib.leaves(ef.residual))]
    return (tree_lib.unflatten(grads, [o[0] for o in out]),
            ErrorFeedback(residual=tree_lib.unflatten(grads,
                                                      [o[1] for o in out])))


__all__ = ["ErrorFeedback", "compress_grads", "error_feedback_init",
           "int8_psum"]
