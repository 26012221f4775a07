"""Shared building blocks of the dense transformer; port of
`repro.models.layers` as plain tensor functions.

Parameters are the JAX package's pytree as a dict of tensors, with the same
layouts (a weight is (d_in, d_out) and applied as ``x @ w``), so that
`convert.params_from_jax` carries them across without a transpose.
"""
from __future__ import annotations

import itertools
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp_lib


class Leaf(NamedTuple):
    """One parameter of a parameter spec: its shape, and either a norm
    weight of ones, a constant (``fill()``: a CPU tensor of ``shape``, the
    same in every stacked layer) or a `dense_init` draw at ``scale`` (None:
    fan-in)."""
    shape: Tuple[int, ...]
    scale: Optional[float] = None
    ones: bool = False
    dtype: Optional[torch.dtype] = None     # None: the tree's dtype
    fill: Optional[Callable[[], torch.Tensor]] = None


def dense_init_(out: torch.Tensor, scale: Optional[float] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill ``out`` in place with a truncated-normal fan-in draw: a standard
    normal cut to [-2, 2], times ``scale`` (default fan_in ** -0.5), drawn
    from ``generator`` on ``out``'s device. An f32 ``out`` takes the draw
    with no temporary. The draws differ from `jax.random.truncated_normal`'s;
    parity tests carry the JAX parameters across instead
    (`convert.params_from_jax`)."""
    shape = tuple(out.shape)
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = fan_in ** -0.5
    u = out if out.dtype == torch.float32 else torch.empty(
        shape, dtype=torch.float32, device=out.device)
    torch.rand(shape, generator=generator, out=u)
    # inverse-CDF sampling: u uniform in (Phi(-2), Phi(2)), x = Phi^-1(u)
    lo = 0.5 * (1.0 + torch.erf(torch.tensor(-2.0 / 2.0 ** 0.5))).item()
    u.mul_(1.0 - 2.0 * lo).add_(lo).mul_(2.0).sub_(1.0).erfinv_()
    u.mul_(2.0 ** 0.5).clamp_(-2.0, 2.0).mul_(scale)
    if u is not out:
        out.copy_(u)
    return out


def dense_init(shape, scale: Optional[float] = None, *,
               generator: Optional[torch.Generator] = None, device,
               dtype=torch.float32) -> torch.Tensor:
    """A new ``shape`` tensor on ``device`` holding `dense_init_`'s draw."""
    return dense_init_(torch.empty(shape, dtype=dtype, device=device), scale,
                       generator=generator)


def init_tree(spec, *, generator: Optional[torch.Generator] = None, device,
              dtype=torch.float32,
              n: Union[int, Tuple[int, ...], None] = None) -> dict:
    """The parameters of ``spec`` (a nested dict of `Leaf`, or one `Leaf`)
    on ``device``.
    With ``n`` (a count or a tuple of counts) every leaf is stacked along
    new leading axes of those extents (the JAX package's ``_stack_init``
    layout; a tuple is its vmap of stacks, e.g. (groups, layers a group)):
    each stacked leaf is allocated once and layer ``i`` (in row-major
    order) is drawn into its slice, layer by layer and within a layer in
    the spec's order, so no second copy of the layers is ever live."""
    lead = () if n is None else (n,) if isinstance(n, int) else tuple(n)

    def alloc(node):
        if isinstance(node, dict):
            return {key: alloc(val) for key, val in node.items()}
        make = torch.ones if node.ones else torch.empty
        return make((*lead, *node.shape), dtype=node.dtype or dtype,
                    device=device)

    def fill(node, t, i):
        if isinstance(node, dict):
            for key, val in node.items():
                fill(val, t[key], i)
        elif node.fill is not None:
            t[i].copy_(node.fill())
        elif not node.ones:
            dense_init_(t[i], node.scale, generator=generator)

    tree = alloc(spec)
    for i in itertools.product(*(range(e) for e in lead)):
        fill(spec, tree, i)
    return tree


def rms_norm(x, weight, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * weight).to(dtype)


def rms_norm_pieces(tp, x, weight, n: int, eps: float = 1e-5):
    """`rms_norm` over ``n`` features of which ``x`` holds this rank's
    piece (``weight`` its piece too): the sum of squares added over
    ``model`` (`tensor_parallel.all_sum`)."""
    dtype = x.dtype
    x = x.float()
    var = tp_lib.all_sum(tp, (x * x).sum(dim=-1, keepdim=True)) / n
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


def mlp_spec(d_model: int, d_ff: int) -> dict:
    return {"w_gate": Leaf((d_model, d_ff)), "w_up": Leaf((d_model, d_ff)),
            "w_down": Leaf((d_ff, d_model))}


def init_mlp(d_model: int, d_ff: int, *, generator=None, device,
             dtype=torch.float32) -> dict:
    return init_tree(mlp_spec(d_model, d_ff), generator=generator,
                     device=device, dtype=dtype)


def apply_mlp(params, x, tp=None, ff: Optional[int] = None):
    """The SwiGLU MLP on ``x``. Under a mesh context ``tp`` the leaves are
    this rank's pieces: ``w_gate`` / ``w_up`` column-parallel and ``w_down``
    row-parallel, split on the hidden width ``ff`` (the whole one), the
    output summed over ``model``."""
    if not tp_lib.active(tp) or not tp_lib.split(
            tp, params["w_gate"].shape[-1], ff):
        return swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
    x = tp_lib.copy_in(tp, x)
    return tp_lib.row(tp, F.silu(x @ params["w_gate"]) * (x @ params["w_up"]),
                      params["w_down"])


__all__ = ["Leaf", "apply_mlp", "apply_rope", "dense_init", "dense_init_",
           "init_mlp", "init_tree", "mlp_spec", "rms_norm", "rms_norm_pieces",
           "rope_freqs", "swiglu"]
