"""AdamW and the cosine LR schedule on nested dicts of tensors; port of
`repro.train.optimizer`.

Three details of the JAX code are kept:
- leaves are visited in JAX's flatten order (`repro_torch.tree`), so
  `clip_by_global_norm` sums the per-leaf squares in that order;
- ``count`` is incremented before ``lr(count)``;
- weight decay applies where ``p.ndim >= 2``, which includes the stacked
  (L, d) norm leaves ``blocks.ln1`` / ``blocks.ln2`` (and a stacked
  ``q_norm`` / ``k_norm``): a quirk of the stacked layout.

Under a mesh the leaves are this rank's pieces (the ZeRO-1 layout of
`train.loop`): ``reduce_sq`` turns the per-piece sums of squares into the
whole leaves' before the global norm. With ``inplace=True`` `adamw_update` writes the new parameters and
moments into the given tensors, leaf by leaf (the counterpart of the JAX
launcher's ``donate_argnums``); the values are the same.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from .. import tree as tree_lib


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor       # () int32


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_lib.leaves(params)[0].device
    return AdamWState(mu=tree_lib.map(zeros, params),
                      nu=tree_lib.map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=device))


def clip_by_global_norm(grads, max_norm: float, reduce_sq=None):
    # the per-leaf sums of squares added in flatten order, as JAX's sum()
    sqs = [torch.sum(g.float() ** 2) for g in tree_lib.leaves(grads)]
    if reduce_sq is not None:
        sqs = reduce_sq(sqs)
    total = None
    for sq in sqs:
        total = sq if total is None else total + sq
    gnorm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_lib.map(lambda g: g * scale, grads), gnorm


def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 inplace: bool = False, reduce_sq=None):
    """One AdamW step. Returns (params, AdamWState, grad norm before
    clipping). ``lr`` is a float or a schedule of the new count;
    ``reduce_sq`` as `clip_by_global_norm`'s."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm, reduce_sq)
    count = state.count + 1
    lr_t = lr(count) if callable(lr) else lr
    cf = count.to(torch.float32)
    bc1 = 1 - torch.pow(b1, cf)
    bc2 = 1 - torch.pow(b2, cf)

    def upd(g, mu, nu, p):
        g = g.float()
        mu_new = b1 * mu + (1 - b1) * g
        nu_new = b2 * nu + (1 - b2) * g * g
        step = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
        decay = weight_decay if p.ndim >= 2 else 0.0
        p32 = p.float()
        new_p = (p32 - lr_t * (step + decay * p32)).to(p.dtype)
        if inplace:
            p.copy_(new_p)
            mu.copy_(mu_new)
            nu.copy_(nu_new)
            return p, mu, nu
        return new_p, mu_new, nu_new

    out = [upd(*leaf) for leaf in zip(tree_lib.leaves(grads),
                                      tree_lib.leaves(state.mu),
                                      tree_lib.leaves(state.nu),
                                      tree_lib.leaves(params))]
    new_p = tree_lib.unflatten(params, [o[0] for o in out])
    new_mu = tree_lib.unflatten(params, [o[1] for o in out])
    new_nu = tree_lib.unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(mu=new_mu, nu=new_nu, count=count), gnorm


__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule"]
