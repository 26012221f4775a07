"""Training step with microbatched gradient accumulation, remat, optional
error-feedback gradient compression and AdamW; port of `repro.train.loop`.

`make_train_step(cfg, train_cfg)` returns ``(state, batch) -> (state,
metrics)``. The microbatches run as a Python loop (the JAX ``lax.scan``),
so only one microbatch of activations is live; their gradients add up in
f32 in the JAX order and are divided by their number, then go through
`compress_grads` when asked and `adamw_update`. Every tensor of the state
stays on the device of its parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .. import tree as tree_lib
from ..distributed.compression import (ErrorFeedback, compress_grads,
                                       error_feedback_init)
from ..models import transformer as model_lib
from .optimizer import AdamWState, adamw_init, adamw_update, cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    microbatches: int = 1
    remat: str = "full"            # none | full | dots
    compress_grads: bool = False   # error-feedback int8 (cross-pod wire fmt)
    max_grad_norm: float = 1.0
    weight_decay: float = 0.1


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Optional[ErrorFeedback]
    step: torch.Tensor             # () int32


def init_state(params, tcfg: TrainCfg) -> TrainState:
    device = tree_lib.leaves(params)[0].device
    return TrainState(
        params=params,
        opt=adamw_init(params),
        ef=error_feedback_init(params) if tcfg.compress_grads else None,
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def _split_microbatches(batch, n: int):
    """(B, ...) -> n microbatches of (B/n, ...) for every leaf (views)."""
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return x.reshape(n, b // n, *x.shape[1:])
    parts = {key: split(val) for key, val in batch.items()}
    return [{key: val[i] for key, val in parts.items()} for i in range(n)]


def _on_device(batch, device):
    return {key: torch.as_tensor(np.asarray(val) if not torch.is_tensor(val)
                                 else val).to(device)
            for key, val in batch.items()}


def make_train_step(cfg, tcfg: TrainCfg, *, donate: bool = False):
    """The train step of ``cfg`` under ``tcfg``. ``batch`` holds ``tokens``
    and ``labels`` (B, S), numpy or tensors; they go to the parameters'
    device. Metrics: ``loss``, ``grad_norm`` and ``lr`` (0-d f32 tensors).

    With ``donate`` the step writes the new parameters and moments into the
    given state's tensors (the counterpart of the JAX launcher's
    ``donate_argnums=(0,)``: one copy of them is live, not two); the values
    are the same. The JAX step's mesh arguments
    (``acc_shardings``, ``mb_shardings``, ``param_shardings``) belong to the
    multi-card training slice and are left out."""
    lr = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)

    def grad_fn(params, mb):
        leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(params)]
        loss, _ = model_lib.loss_fn(tree_lib.unflatten(params, leaves), cfg,
                                    mb, remat=tcfg.remat)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), [g.float() for g in grads]

    def train_step(state: TrainState, batch):
        device = state.step.device
        batch = _on_device(batch, device)
        if tcfg.microbatches > 1:
            g_acc, loss_acc = None, torch.zeros((), dtype=torch.float32,
                                                device=device)
            for mb in _split_microbatches(batch, tcfg.microbatches):
                loss, g = grad_fn(state.params, mb)
                if g_acc is None:
                    g_acc = [torch.zeros_like(gi).add_(gi) for gi in g]
                else:
                    for acc, gi in zip(g_acc, g):
                        acc.add_(gi)
                loss_acc = loss_acc + loss
                del g
            grads = [gi.div_(tcfg.microbatches) for gi in g_acc]
            loss = loss_acc / tcfg.microbatches
        else:
            loss, grads = grad_fn(state.params, batch)
        grads = tree_lib.unflatten(state.params, grads)

        ef = state.ef
        if tcfg.compress_grads:
            grads, ef = compress_grads(grads, ef)

        params, opt, gnorm = adamw_update(
            grads, state.opt, state.params, lr=lr,
            weight_decay=tcfg.weight_decay, max_grad_norm=tcfg.max_grad_norm,
            inplace=donate)
        new_state = TrainState(params=params, opt=opt, ef=ef,
                               step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm,
                           "lr": lr(opt.count)}

    return train_step


__all__ = ["TrainCfg", "TrainState", "init_state", "make_train_step"]
