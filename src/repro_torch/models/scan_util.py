"""The scan of the recurrent blocks; port of `repro.models.scan_util`.

`scan(body, carry, xs)` is `jax.lax.scan` as a Python loop: ``body(carry,
x) -> (carry, y)`` over the leading axis of ``xs`` (a tensor or a tuple of
tensors), the ``y`` tensors stacked along a new leading axis as
`lax.scan` stacks them.

The JAX module's ``UNROLL`` switch and ``set_unroll`` are left out: they
make XLA's cost analysis count a loop body once per trip for the JAX
roofline, and the port's roofline (`launch/roofline.py`) counts from shapes
instead. Its ``force_loop`` argument goes with them: every port scan is a
loop.
"""
from __future__ import annotations

import torch


def scan(body, carry, xs):
    n = xs[0].shape[0] if isinstance(xs, tuple) else xs.shape[0]
    ys = []
    for i in range(n):
        x = tuple(t[i] for t in xs) if isinstance(xs, tuple) else xs[i]
        carry, y = body(carry, x)
        ys.append(y)
    return carry, torch.stack(ys)


__all__ = ["scan"]
