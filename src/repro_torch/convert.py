"""Carry an index or a streaming index across from the JAX package.

The index is the port's state: `index_from_numpy` takes the JAX package's
`IndexArrays` as numpy arrays by field name plus its `IndexMeta` fields,
and `index_from_dir` reads a ``promips`` backend's save directory
(``arrays.npz`` with one array per `IndexArrays` field, ``meta.json`` with
the `IndexMeta` fields under ``backend_meta.meta``). Both return the port's
(IndexArrays, IndexMeta) on one device.

A streaming index's state is the JAX `MutableProMIPS.state_dict()` pair:
`stream_from_state` restores it as the port's `MutableProMIPS`, and
`stream_from_dir` reads a ``promips-stream`` save directory (the same
arrays in ``arrays.npz``, the state meta under ``backend_meta``).

A model's state is its parameter pytree: `params_from_jax` takes the JAX
`models.transformer.init_params` tree (numpy or JAX arrays) as the port's
parameters, which keep the JAX layouts, so every leaf is copied bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping

import numpy as np
import torch

from .core.index import IndexArrays, IndexMeta, resolve_device, to_device
from .models.transformer import check_supported
from .stream.mutable import MutableProMIPS

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


def _param_keys(cfg) -> dict:
    """The parameter tree of a dense decoder, as nested key sets."""
    attn = {"wq", "wk", "wv", "wo"} | ({"q_norm", "k_norm"} if cfg.qk_norm
                                       else set())
    keys = {"embed": None, "final_norm": None,
            "blocks": {"ln1": None, "ln2": None,
                       "attn": dict.fromkeys(attn),
                       "mlp": dict.fromkeys(("w_gate", "w_up", "w_down"))}}
    if not cfg.tie_embeddings:
        keys["unembed"] = None
    return keys


def params_from_jax(tree: Mapping, cfg, device="cuda") -> dict:
    """The port's parameters on ``device`` from the JAX package's
    `init_params(key, cfg)` tree: the same nested dict, every leaf copied
    bit for bit (the ``blocks`` leaves keep their leading layer axis). Raises
    on a tree that is not a dense decoder's."""
    check_supported(cfg)
    dev = resolve_device(device)

    def convert(node, keys, path):
        if keys is None:
            arr = np.array(node, copy=True)
            return torch.from_numpy(arr).to(dev)
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
    if params["blocks"]["ln1"].shape != (cfg.n_layers, cfg.d_model):
        raise ValueError(f"params['blocks'] hold "
                         f"{params['blocks']['ln1'].shape[0]} layers, the "
                         f"config ({cfg.name}) {cfg.n_layers}")
    return params
