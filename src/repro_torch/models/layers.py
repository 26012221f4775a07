"""Shared building blocks of the dense transformer; port of
`repro.models.layers` as plain tensor functions.

Parameters are the JAX package's pytree as a dict of tensors, with the same
layouts (a weight is (d_in, d_out) and applied as ``x @ w``), so that
`convert.params_from_jax` carries them across without a transpose.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dense_init(shape, scale: Optional[float] = None, *,
               generator: Optional[torch.Generator] = None, device,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut to [-2, 2],
    times ``scale`` (default fan_in ** -0.5), drawn from ``generator`` on
    ``device`` (the generator's device). The draws differ from
    `jax.random.truncated_normal`'s; parity tests carry the JAX parameters
    across instead (`convert.params_from_jax`)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = fan_in ** -0.5
    # inverse-CDF sampling: u uniform in (Phi(-2), Phi(2)), x = Phi^-1(u)
    lo = 0.5 * (1.0 + torch.erf(torch.tensor(-2.0 / 2.0 ** 0.5))).item()
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    x = torch.erfinv(2.0 * (lo + (1.0 - 2.0 * lo) * u) - 1.0) * 2.0 ** 0.5
    return (x.clamp_(-2.0, 2.0) * scale).to(dtype)


def rms_norm(x, weight, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * weight).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, dh), positions: (..., S) integers."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)               # (dh/2,)
    angles = positions[..., None].float() * freqs               # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: down(silu(x @ gate) * (x @ up))."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def init_mlp(d_model: int, d_ff: int, *, generator=None, device,
             dtype=torch.float32) -> dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "w_gate": dense_init((d_model, d_ff), **kw),
        "w_up": dense_init((d_model, d_ff), **kw),
        "w_down": dense_init((d_ff, d_model), **kw),
    }


def apply_mlp(params, x):
    return swiglu(x, params["w_gate"], params["w_up"], params["w_down"])


__all__ = ["apply_mlp", "apply_rope", "dense_init", "init_mlp", "rms_norm",
           "rope_freqs", "swiglu"]
