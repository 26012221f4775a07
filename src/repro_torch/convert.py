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
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping

import numpy as np

from .core.index import IndexArrays, IndexMeta, to_device
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
