"""Carry an index or a streaming index across from the JAX package.

The index is the port's state: `index_from_numpy` takes the JAX package's
`IndexArrays` as numpy arrays by field name plus its `IndexMeta` fields,
and `index_from_dir` reads a ``promips`` backend's save directory
(``arrays.npz`` with one array per `IndexArrays` field, ``meta.json`` with
the `IndexMeta` fields under ``backend_meta.meta``). Both return the port's
(IndexArrays, IndexMeta) on one device.

A ``promips`` backend's state is the JAX `PromipsSearcher.state()` pair:
`promips_from_state` restores it as the port's `PromipsSearcher` (the
index arrays, meta, runtime settings and search path; no rebuild).

A streaming index's state is the JAX `MutableProMIPS.state_dict()` pair:
`stream_from_state` restores it as the port's `MutableProMIPS`, and
`stream_from_dir` reads a ``promips-stream`` save directory (the same
arrays in ``arrays.npz``, the state meta under ``backend_meta``).

A sharded streaming index's state is the JAX
`MutableShardedProMIPS.state_dict()` pair (each shard's stream state under
a ``shard{i}_`` prefix, plus the routing bounds): `sharded_from_state`
restores it as the port's `MutableShardedProMIPS`, and `sharded_from_dir`
reads a ``sharded`` save directory. (`api.load` reads every backend's save
directory, the runtime settings included.)

A model's state is its parameter pytree: `params_from_jax` takes the JAX
`models.transformer.init_params` tree (numpy or JAX arrays) of any
model (dense, MoE, the vision stub, the encoder-decoder, the xLSTM and the
Mamba2 hybrid) as the port's parameters, which keep the JAX layouts, so every leaf is
copied bit for bit, in its own dtype (a bf16 tree stays bf16: the leaves
travel as their 16-bit patterns, with no `ml_dtypes` in the port). A
trainer's state is the JAX `train.loop.TrainState`: `train_state_from_jax`
carries its parameters, AdamW moments and count, error-feedback residuals
and step across.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping

import numpy as np
import torch

from .core.index import IndexArrays, IndexMeta, resolve_device, to_device
from .core.sharded import MutableShardedProMIPS
from .distributed.compression import ErrorFeedback
from .models.transformer import Stacked, check_supported, param_spec
from . import tree as tree_lib
from .stream.mutable import MutableProMIPS
from .train.loop import TrainState
from .train.optimizer import AdamWState

_FORMAT_NAME = "repro.api-index"


def index_from_numpy(arrays: Mapping[str, np.ndarray], meta: Mapping,
                     device="cuda"):
    """(IndexArrays, IndexMeta) on ``device`` from arrays keyed by field name
    and a mapping of `IndexMeta` fields (extra keys are ignored)."""
    missing = [f for f in IndexArrays._fields if f not in arrays]
    if missing:
        raise KeyError(f"index arrays lack fields: {missing}")
    names = {f.name for f in dataclasses.fields(IndexMeta)}
    index_meta = IndexMeta(**{k: v for k, v in meta.items() if k in names})
    host = IndexArrays(**{f: np.asarray(arrays[f]) for f in IndexArrays._fields})
    return to_device(host, device), index_meta


def _read_dir(path: str, backend: str):
    """(arrays, backend_meta) of an ``api`` save directory of ``backend``."""
    with open(os.path.join(path, "meta.json")) as f:
        header = json.load(f)
    if header.get("format") != _FORMAT_NAME:
        raise ValueError(f"{path!r}: not a {_FORMAT_NAME} directory")
    if header.get("backend") != backend:
        raise ValueError(f"{path!r}: saved by backend "
                         f"{header.get('backend')!r}, not {backend!r}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {key: z[key] for key in z.files}
    return arrays, header["backend_meta"]


def index_from_dir(path: str, device="cuda"):
    """(IndexArrays, IndexMeta) on ``device`` from a ``promips`` save dir."""
    arrays, backend_meta = _read_dir(path, "promips")
    return index_from_numpy(arrays, backend_meta["meta"], device)


def promips_from_state(arrays: Mapping[str, np.ndarray], meta: Mapping,
                       device="cuda"):
    """The port's `api.adapters.PromipsSearcher` on ``device`` from the JAX
    `PromipsSearcher.state()` output (arrays by `IndexArrays` field; meta
    with the index meta, runtime settings and search path). The JAX
    runtime's ``use_pallas`` is dropped: the port picks its kernels by
    device."""
    from .api.adapters import PromipsSearcher
    return PromipsSearcher.from_state(dict(arrays), dict(meta), device=device)


def stream_from_state(arrays: Mapping[str, np.ndarray], meta: Mapping,
                      device="cuda") -> MutableProMIPS:
    """The port's `MutableProMIPS` on ``device`` from the JAX
    `MutableProMIPS.state_dict()` output (no rebuild)."""
    return MutableProMIPS.from_state(dict(arrays), dict(meta), device=device)


def stream_from_dir(path: str, device="cuda") -> MutableProMIPS:
    """The port's `MutableProMIPS` on ``device`` from a ``promips-stream``
    save directory (its runtime settings are not carried)."""
    arrays, backend_meta = _read_dir(path, "promips-stream")
    return stream_from_state(arrays, backend_meta, device)


def sharded_from_state(arrays: Mapping[str, np.ndarray], meta: Mapping,
                       device="cuda") -> MutableShardedProMIPS:
    """The port's `MutableShardedProMIPS` on ``device`` from the JAX
    `MutableShardedProMIPS.state_dict()` output (no rebuild)."""
    return MutableShardedProMIPS.from_state(dict(arrays), dict(meta),
                                            device=device)


def sharded_from_dir(path: str, device="cuda") -> MutableShardedProMIPS:
    """The port's `MutableShardedProMIPS` on ``device`` from a ``sharded``
    save directory (its runtime settings are not carried)."""
    arrays, backend_meta = _read_dir(path, "sharded")
    return sharded_from_state(arrays, backend_meta, device)


def _param_keys(cfg) -> dict:
    """The parameter tree of `transformer.param_spec` as nested key sets
    (None at a leaf)."""
    def keys(node):
        if isinstance(node, Stacked):
            node = node.spec
        if isinstance(node, dict):
            return {k: keys(v) for k, v in node.items()}
        return None
    return keys(param_spec(cfg))


def params_from_jax(tree: Mapping, cfg, device="cuda") -> dict:
    """The port's parameters on ``device`` from the JAX package's
    `init_params(key, cfg)` tree: the same nested dict, every leaf copied
    bit for bit (the stacked leaves keep their leading layer axis). Raises
    on a tree that is not the config's."""
    check_supported(cfg)
    dev = resolve_device(device)

    def convert(node, keys, path):
        if keys is None:
            return tree_lib.leaf_from_numpy(node).to(dev)
        if not isinstance(node, Mapping) or set(node) != set(keys):
            got = sorted(node) if isinstance(node, Mapping) else type(node)
            raise ValueError(f"params{path}: expected keys {sorted(keys)}, "
                             f"got {got}")
        return {k: convert(node[k], keys[k], f"{path}[{k!r}]") for k in keys}

    params = convert(tree, _param_keys(cfg), "")
    if params["embed"].shape != (cfg.vocab_padded, cfg.d_model):
        raise ValueError(f"params['embed'] has shape "
                         f"{tuple(params['embed'].shape)}, the config "
                         f"({cfg.name}) needs {(cfg.vocab_padded, cfg.d_model)}")
    # each layer stack's leading extents: (L,) for ``blocks``, (G, 7) and
    # (G,) for the xLSTM's ``mlstm`` and ``slstm``, (G, every) and (rem,)
    # for the hybrid's ``mamba`` and ``mamba_tail``
    for key, node in param_spec(cfg).items():
        if not (isinstance(node, Stacked) and isinstance(node.spec, dict)):
            continue
        want = (node.n,) if isinstance(node.n, int) else tuple(node.n)
        got = tuple(params[key][next(iter(node.spec))].shape[:len(want)])
        if got != want:
            raise ValueError(f"params[{key!r}] hold {got} layers, the "
                             f"config ({cfg.name}) {want}")
    return params


def train_state_from_jax(state, cfg, device="cuda"):
    """The port's `train.loop.TrainState` on ``device`` from the JAX
    `TrainState` (params, ``opt.mu`` / ``opt.nu`` / ``opt.count``, ``ef``
    or None, ``step``), every leaf bit for bit."""
    dev = resolve_device(device)

    def scalar(x):
        return torch.from_numpy(np.array(x, dtype=np.int32, copy=True)).to(dev)

    ef = None
    if state.ef is not None:
        ef = ErrorFeedback(residual=params_from_jax(state.ef.residual, cfg, dev))
    return TrainState(
        params=params_from_jax(state.params, cfg, dev),
        opt=AdamWState(mu=params_from_jax(state.opt.mu, cfg, dev),
                       nu=params_from_jax(state.opt.nu, cfg, dev),
                       count=scalar(state.opt.count)),
        ef=ef, step=scalar(state.step))
