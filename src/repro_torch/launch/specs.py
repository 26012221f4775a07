"""Abstract inputs and specs of every (arch x shape x mesh) cell;
counterpart of `repro.launch.specs`.

Nothing here allocates: the structs are tensors on the ``meta`` device
(JAX's ``ShapeDtypeStruct``), the specs are `sharding.P` trees (JAX's
``NamedSharding`` without jax: the mesh is passed beside them), and the
production mesh is abstract (`mesh.make_production_mesh`). The parameter
structs carry JAX's bf16 `model_dtype` (the leaves the port keeps in their
own dtype, as the JAX ones, keep it); the optimizer state is f32, as in
JAX. The cell functions follow the dtype of the tensors they are given:
real bf16 parameters (`init_params(..., dtype=model_dtype(cfg))`) run the
JAX cells' program, f32 ones the f32 program.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..configs import ArchConfig, ShapeCfg
from ..distributed import sharding as shard_lib
from ..distributed import tensor_parallel as tp_lib
from ..distributed.compression import ErrorFeedback
from ..distributed.sharding import P
from ..models import transformer as model_lib
from ..train.loop import TrainCfg, TrainState, init_state, make_train_step
from ..train.optimizer import AdamWState

META = torch.device("meta")


def model_dtype(cfg):
    return torch.bfloat16


def abstract_params(cfg: ArchConfig):
    """The parameter tree of `transformer.param_spec` on ``meta``."""
    dtype = model_dtype(cfg)

    def alloc(node, lead):
        if isinstance(node, dict):
            return {k: alloc(v, lead) for k, v in node.items()}
        return torch.empty((*lead, *node.shape), dtype=node.dtype or dtype,
                           device=META)

    params = {}
    for key, node in model_lib.param_spec(cfg).items():
        if isinstance(node, model_lib.Stacked):
            lead = (node.n,) if isinstance(node.n, int) else tuple(node.n)
            params[key] = alloc(node.spec, lead)
        else:
            params[key] = alloc(node, ())
    return params


def choose_microbatches(cfg: ArchConfig, shape: ShapeCfg, mesh) -> int:
    """Grad-accum factor so one microbatch's activations fit HBM.

    Heuristic: target <= ~4096 tokens per data-parallel shard per microbatch
    for >= 8B-param models, <= 16384 otherwise; clipped to divisors of the
    global batch.
    """
    dp = shard_lib.axis_size(mesh, shard_lib.dp_axes(mesh))
    tokens_per_shard = shape.global_batch * shape.seq_len // dp
    big = cfg.param_count() >= 8e9
    target = 2048 if big else 16384
    mb = max(1, tokens_per_shard // target)
    while shape.global_batch % mb:
        mb -= 1
    return max(1, mb)


def train_cfg_for(cfg: ArchConfig, shape: ShapeCfg, mesh) -> TrainCfg:
    return TrainCfg(microbatches=choose_microbatches(cfg, shape, mesh), remat="full")


def batch_structs(cfg: ArchConfig, shape: ShapeCfg) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": torch.empty((b, s), dtype=torch.int32, device=META),
        "labels": torch.empty((b, s), dtype=torch.int32, device=META),
    }
    frontend = (b, cfg.frontend_len, cfg.d_model)
    if cfg.frontend == "vision":
        batch["patches"] = torch.empty(frontend, dtype=model_dtype(cfg), device=META)
    if cfg.frontend == "audio":
        batch["frames"] = torch.empty(frontend, dtype=model_dtype(cfg), device=META)
    return batch


def state_structs(cfg: ArchConfig, tcfg: TrainCfg):
    return init_state(abstract_params(cfg), tcfg)


def state_shardings(cfg: ArchConfig, tcfg: TrainCfg, mesh):
    """The train state's specs: the parameters under `param_specs`, the
    moments and the residual under `zero1_specs` (ZeRO-1), the counters
    whole."""
    params_shape = abstract_params(cfg)
    pspec = shard_lib.param_specs(params_shape, mesh)
    zspec = shard_lib.zero1_specs(params_shape, mesh)
    return TrainState(
        params=pspec,
        opt=AdamWState(mu=zspec, nu=zspec, count=P()),
        ef=ErrorFeedback(residual=zspec) if tcfg.compress_grads else None,
        step=P(),
    )


def cache_structs(cfg: ArchConfig, shape: ShapeCfg):
    return model_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                model_dtype(cfg), device=META)


def cache_shardings(cfg: ArchConfig, shape: ShapeCfg, mesh):
    """The decode cache's spec tree (`cache_specs` per leaf; a tuple leaf
    such as the sLSTM state takes its entry's spec by index)."""
    specs = shard_lib.cache_specs(cfg, shape, mesh)

    def spec_of(path, leaf):
        sp = specs.get(path[0], None)
        if isinstance(sp, tuple) and not isinstance(sp, P):
            sp = sp[path[1]]
        if sp is None:
            sp = P(*([None] * leaf.ndim))
        return sp

    return shard_lib.tree_map_with_path(spec_of, cache_structs(cfg, shape))


# ---------------------------------------------------------------------------
# step functions per cell kind
# ---------------------------------------------------------------------------

def build_cell(cfg: ArchConfig, shape: ShapeCfg, mesh,
               microbatch_override: int | None = None):
    """Returns (fn, abstract_args, in_specs, out_specs) for the cell.

    The train function is `make_train_step` under ``mesh`` with the ZeRO-1
    layouts (``acc_specs`` = `zero1_specs`, ``param_specs``, the
    microbatch specs from `batch_specs`): on a rank of ``mesh`` it takes
    the state's pieces and the whole batch, and splits its compute over
    ``model``. The prefill function takes the parameters' pieces and this
    rank's batch rows and returns the cache in `cache_shardings`' layout
    and the logits in `logits_spec`'s (`transformer.prefill` under the
    mesh context). The decode function ``serve_step(params, cache, token,
    use_kernels=None)`` takes the parameters' pieces, the cache's pieces in
    `cache_shardings`' layout and this rank's token rows, runs
    `transformer.decode_step` under the mesh context with the cache's K/V
    cut (`sharding.kv_layout`), updates the cache pieces in place and
    returns (this rank's rows' logits in `logits_spec`'s vocab layout, the
    cache); its ``tp`` attribute is the mesh context, whose ``sync_s``
    adds up the seconds in its collectives. As for the prefill, the logits
    are this rank's batch rows."""
    if shape.kind == "train":
        tcfg = train_cfg_for(cfg, shape, mesh)
        if microbatch_override is not None:
            tcfg = dataclasses.replace(tcfg, microbatches=microbatch_override)
        params_shape = abstract_params(cfg)
        mb_specs = {k: P(None, *s)
                    for k, s in shard_lib.batch_specs(cfg, shape, mesh).items()}
        step = make_train_step(
            cfg, tcfg, mesh=mesh,
            acc_specs=shard_lib.zero1_specs(params_shape, mesh),
            mb_specs=mb_specs,
            param_specs=shard_lib.param_specs(params_shape, mesh))
        st_specs = state_shardings(cfg, tcfg, mesh)
        args = (state_structs(cfg, tcfg), batch_structs(cfg, shape))
        in_specs = (st_specs, shard_lib.batch_specs(cfg, shape, mesh))
        out_specs = (st_specs, P())
        return step, args, in_specs, out_specs

    params_struct = abstract_params(cfg)
    p_specs = shard_lib.param_specs(params_struct, mesh)

    if shape.kind == "prefill":
        c_specs = cache_shardings(cfg, shape, mesh)

        def prefill_step(params, batch):
            return model_lib.prefill(params, cfg, batch, shape.seq_len,
                                     tp=tp_lib.context(mesh),
                                     cache_specs=c_specs)
        args = (params_struct, batch_structs(cfg, shape))
        in_specs = (p_specs, shard_lib.batch_specs(cfg, shape, mesh))
        out_specs = (c_specs, shard_lib.logits_spec(cfg, mesh))
        return prefill_step, args, in_specs, out_specs

    if shape.kind == "decode":
        tp = tp_lib.context(mesh)
        layout = shard_lib.kv_layout(cfg, shape, mesh)

        def serve_step(params, cache, token, use_kernels=None):
            return model_lib.decode_step(params, cfg, cache, token, tp=tp,
                                         kv_layout=layout,
                                         use_kernels=use_kernels)
        serve_step.tp = tp
        token = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                            device=META)
        args = (params_struct, cache_structs(cfg, shape), token)
        c_specs = cache_shardings(cfg, shape, mesh)
        in_specs = (p_specs, c_specs,
                    shard_lib.decode_token_spec(cfg, shape, mesh))
        out_specs = (shard_lib.logits_spec(cfg, mesh), c_specs)
        return serve_step, args, in_specs, out_specs

    raise ValueError(shape.kind)


def cell_applicable(cfg: ArchConfig, shape: ShapeCfg):
    """(ok, reason) — long_500k only for sub-quadratic families (DESIGN §6)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "skipped(full-attention)"
    return True, ""


__all__ = ["abstract_params", "batch_structs", "build_cell", "cache_shardings",
           "cache_structs", "cell_applicable", "choose_microbatches",
           "model_dtype", "state_shardings", "state_structs", "train_cfg_for"]
