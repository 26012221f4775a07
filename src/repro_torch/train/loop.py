"""Training step with microbatched gradient accumulation, remat, optional
error-feedback gradient compression and AdamW; port of `repro.train.loop`.

`make_train_step(cfg, train_cfg)` returns ``(state, batch) -> (state,
metrics)``. The microbatches run as a Python loop (the JAX ``lax.scan``),
so only one microbatch of activations is live; their gradients add up in
f32 in the JAX order and are divided by their number, then go through
`compress_grads` when asked and `adamw_update`. Every tensor of the state
stays on the device of its parameters.

Under a mesh (`launch.mesh.Mesh`, one process a rank) the state holds
this rank's pieces: the parameters under ``param_specs``, the moments and
the residual under ``acc_specs`` (the ZeRO-1 layout of
`distributed.sharding.zero1_specs`, or ``param_specs``). A step runs
`loss_fn` on the parameter pieces under the mesh context
(`distributed.tensor_parallel`): the forward and backward are split over
``model`` as GSPMD splits the JAX step, no parameter is gathered, and each
gradient arrives as its leaf's ``param_specs`` piece. The step then
reduces the gradient over the batch's data axes into the accumulator's
layout (every microbatch a reduce-scatter into this rank's piece for a
leaf split over those axes; for the others a local sum of the
microbatches and one all-reduce a step), runs AdamW on the local pieces
and all-gathers the new parameters back to ``param_specs``, as the JAX
step's ``acc_shardings`` / ``param_shardings`` lay it out. A mesh whose
``model`` axis is one rank runs the one-process `loss_fn`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .. import tree as tree_lib
from ..distributed.compression import (ErrorFeedback, compress_grads,
                                       error_feedback_init)
from ..distributed import tensor_parallel as tp_lib
from ..distributed.sharding import P, dp_axes, reshard, shard, slice_piece
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


def make_train_step(cfg, tcfg: TrainCfg, *, mesh=None, acc_specs=None,
                    mb_specs=None, param_specs=None, donate: bool = False):
    """The train step of ``cfg`` under ``tcfg``. ``batch`` holds ``tokens``
    and ``labels`` (B, S), numpy or tensors; they go to the parameters'
    device. Metrics: ``loss``, ``grad_norm`` and ``lr`` (0-d f32 tensors).

    With ``donate`` the step writes the new parameters and moments into the
    given state's tensors (the counterpart of the JAX launcher's
    ``donate_argnums=(0,)``: one copy of them is live, not two); the values
    are the same.

    With a ``mesh`` the state holds this rank's pieces (the module's
    docstring) and ``batch`` is the whole batch on every rank: microbatch
    ``i`` is rows ``[i B/n, (i+1) B/n)`` and this rank computes its slice
    under ``mb_specs`` (per leaf, the spec of the (n, B/n, ...) stack: the
    JAX ``mb_shardings``; default the data axes on the batch dim where they
    divide it). ``param_specs`` (default: every leaf whole on every rank)
    and ``acc_specs`` (default ``param_specs``) are the JAX step's
    ``param_shardings`` and ``acc_shardings``. The metrics add the host
    seconds of the step's collectives: ``grad_sync_s`` for the gradient
    reductions, ``param_sync_s`` for the gathers of the new parameters
    after AdamW, ``tp_sync_s`` for the ``model``-axis collectives of the
    forward and backward."""
    lr = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)

    def grad_fn(params, mb, tp=None):
        leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(params)]
        loss, _ = model_lib.loss_fn(tree_lib.unflatten(params, leaves), cfg,
                                    mb, remat=tcfg.remat, tp=tp)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), [g.float() for g in grads]

    if mesh is not None:
        return _sharded_step(tcfg, lr, grad_fn, mesh, acc_specs, mb_specs,
                             param_specs, donate)

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


def _split_axes(spec, mesh) -> tuple:
    """The mesh axes that split a leaf under ``spec``, in mesh order."""
    named = set()
    for entry in spec:
        named.update((entry,) if isinstance(entry, str) else entry or ())
    return tuple(a for a in mesh.axis_names if a in named)


def _scalar_reducer(mesh, leaf_axes, op: str):
    """Maps one scalar a leaf, computed on this rank's piece, to the whole
    leaf's: the scalars of the leaves split over the same axes go through
    one all-reduce (``op``), the others stay."""
    def reduce(values):
        out = list(values)
        by_axes = {}
        for i, axes in enumerate(leaf_axes):
            if mesh.axis_size(axes) > 1:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            stacked = mesh.all_reduce(torch.stack([values[i] for i in idx]),
                                      axes, op)
            for j, i in enumerate(idx):
                out[i] = stacked[j]
        return out
    return reduce


def _mean_over(mesh, tensors, axes) -> None:
    """Each tensor, in place, the mean of its copies on the ranks along
    ``axes`` (one all-reduce with every tensor in flight)."""
    mesh.all_reduce_many(tensors, axes)
    n = mesh.axis_size(axes)
    for t in tensors:
        t.div_(n)


def _scatter_mean(mesh, grads, p_specs, a_specs, axes) -> list:
    """Each gradient (this rank's piece under its ``p_specs`` entry, the
    same on the ranks along ``axes``) reduced over those ranks into this
    rank's piece under its ``a_specs`` entry, divided by their number: a
    reduce-scatter (each rank receives its piece only), every leaf in
    flight at once."""
    members = mesh.members(axes)
    chunks = [torch.cat([slice_piece(g, ps, a, mesh, coords=c).reshape(-1)
                         for c in members])
              for g, ps, a in zip(grads, p_specs, a_specs)]
    sums = mesh.reduce_scatter_many(chunks, axes)
    n = mesh.axis_size(axes)
    return [t.view(slice_piece(g, ps, a, mesh).shape).div_(n)
            for t, g, ps, a in zip(sums, grads, p_specs, a_specs)]


def _synced(device) -> float:
    """The host clock after the device's queued work (a timing fence)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _sharded_step(tcfg, lr, grad_fn, mesh, acc_specs, mb_specs, param_specs,
                  donate):
    """`make_train_step` under ``mesh`` (see there)."""
    n = tcfg.microbatches

    def train_step(state: TrainState, batch):
        device = state.step.device
        p_leaves = tree_lib.leaves(state.params)
        p_specs = (tree_lib.leaves(param_specs) if param_specs is not None
                   else [P()] * len(p_leaves))
        a_specs = (tree_lib.leaves(acc_specs) if acc_specs is not None
                   else p_specs)
        tp = tp_lib.context(mesh)
        batch = _on_device(batch, device)
        mbs = _split_microbatches(batch, n)
        specs = mb_specs
        if specs is None:
            dp = dp_axes(mesh)
            rows = mbs[0]["tokens"].shape[0]
            bdim = dp if rows % mesh.axis_size(dp) == 0 else None
            specs = {k: P(None, bdim) for k in batch}
        red = _split_axes(P(specs["tokens"][1]), mesh)
        n_red = mesh.axis_size(red)
        # a leaf whose accumulator is split over the batch's axes (ZeRO-1)
        # is reduce-scattered into its piece every microbatch, as the JAX
        # step's constraint does; any other sums its microbatches here and
        # is all-reduced once a step (the same sum, half the traffic at 2)
        now = [n_red > 1 and bool(set(_split_axes(s, mesh)) & set(red))
               for s in a_specs]
        grad_sync_s = 0.0
        acc, loss_acc = None, None
        for mb in mbs:
            local = {k: shard(v, P(*specs[k][1:]), mesh) for k, v in mb.items()}
            loss, g = grad_fn(state.params, local, tp)
            t0 = _synced(device)
            scattered = iter(_scatter_mean(
                mesh, [gi for gi, r in zip(g, now) if r],
                [s for s, r in zip(p_specs, now) if r],
                [s for s, r in zip(a_specs, now) if r], red))
            pieces = [next(scattered) if r else slice_piece(gi, ps, a, mesh)
                      for gi, ps, a, r in zip(g, p_specs, a_specs, now)]
            grad_sync_s += _synced(device) - t0
            if acc is None:
                acc, loss_acc = [p.clone() for p in pieces], loss
            else:
                for a, p in zip(acc, pieces):
                    a.add_(p)
                loss_acc = loss_acc + loss
            del g, pieces
        t0 = _synced(device)
        if n_red > 1:
            _mean_over(mesh, [a for a, r in zip(acc, now) if not r], red)
        grad_sync_s += _synced(device) - t0
        if n > 1:
            acc = [a.div_(n) for a in acc]
            loss_acc = loss_acc / n
        loss = mesh.all_reduce(loss_acc.clone(), red).div_(n_red) \
            if n_red > 1 else loss_acc
        grads = tree_lib.unflatten(state.params, acc)
        leaf_axes = [_split_axes(s, mesh) for s in a_specs]

        ef = state.ef
        if tcfg.compress_grads:
            grads, ef = compress_grads(
                grads, ef, reduce_max=_scalar_reducer(mesh, leaf_axes, "max"))
        # the parameters sliced into the moments' layout: a local view
        params_in = tree_lib.unflatten(state.params, [
            reshard(p, ps, a, mesh) for p, ps, a in zip(p_leaves, p_specs, a_specs)])
        new_p, opt, gnorm = adamw_update(
            grads, state.opt, params_in, lr=lr, weight_decay=tcfg.weight_decay,
            max_grad_norm=tcfg.max_grad_norm, inplace=donate,
            reduce_sq=_scalar_reducer(mesh, leaf_axes, "sum"))
        t0 = _synced(device)
        out = []
        for old, new, ps, a in zip(p_leaves, tree_lib.leaves(new_p), p_specs,
                                   a_specs):
            whole = reshard(new, a, ps, mesh)
            if donate and whole is not old:
                old.copy_(whole)
                whole = old
            out.append(whole)
        param_sync_s = _synced(device) - t0
        new_state = TrainState(params=tree_lib.unflatten(state.params, out),
                               opt=opt, ef=ef, step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm,
                           "lr": lr(opt.count), "grad_sync_s": grad_sync_s,
                           "param_sync_s": param_sync_s,
                           "tp_sync_s": tp.sync_s if tp is not None else 0.0}

    return train_step


__all__ = ["TrainCfg", "TrainState", "init_state", "make_train_step"]
