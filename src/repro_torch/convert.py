"""Carry an index across from the JAX package.

The index is the port's state: `index_from_numpy` takes the JAX package's
`IndexArrays` as numpy arrays by field name plus its `IndexMeta` fields,
and `index_from_dir` reads a ``promips`` backend's save directory
(``arrays.npz`` with one array per `IndexArrays` field, ``meta.json`` with
the `IndexMeta` fields under ``backend_meta.meta``). Both return the port's
(IndexArrays, IndexMeta) on one device.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping

import numpy as np

from .core.index import IndexArrays, IndexMeta, to_device

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


def index_from_dir(path: str, device="cuda"):
    """(IndexArrays, IndexMeta) on ``device`` from a ``promips`` save dir."""
    with open(os.path.join(path, "meta.json")) as f:
        header = json.load(f)
    if header.get("format") != _FORMAT_NAME:
        raise ValueError(f"{path!r}: not a {_FORMAT_NAME} directory")
    if header.get("backend") != "promips":
        raise ValueError(f"{path!r}: saved by backend "
                         f"{header.get('backend')!r}, not 'promips'")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {key: z[key] for key in z.files}
    return index_from_numpy(arrays, header["backend_meta"]["meta"], device)
