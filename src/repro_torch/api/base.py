"""`Searcher`: the protocol every registered backend implements; port of
`repro.api.base`.

A backend is a class with ``name`` / ``capabilities`` class attributes, a
``build(x, *, guarantee, seed, page_bytes, **opts)`` classmethod and
``_search(queries, k, **opts)`` returning raw (ids, scores, stats dict).
The base class owns what must behave alike across backends: query
validation, the wall-time stamp, the `SearchResult` envelope and the
capability-gated mutation stubs.

Queries may be torch tensors (the serve engine passes its hidden states on
the card, checked on static properties only, with no host copy) or
anything numpy takes. Results come back as numpy arrays, as in the JAX
package.

Persistence is the JAX package's on-disk format: one directory holding
``arrays.npz`` (the backend's ``state()`` arrays, `np.savez_compressed`),
``meta.json`` (the header below, with the backend's meta) and the
checksummed ``manifest.json`` of `robust.snapshot`, written atomically. So
each package loads the other's saves. `load` puts the index on a device,
the card unless ``device="cpu"``.
"""
from __future__ import annotations

import abc
import dataclasses
import json
import os
import time
from typing import ClassVar, Optional, Tuple

import numpy as np
import torch

from ..core.index import resolve_device
from ..robust.snapshot import (CorruptSnapshotError, verify_dir,
                               write_atomic_dir)
from .types import Capabilities, GuaranteeConfig, SearchResult

FORMAT_NAME = "repro.api-index"
FORMAT_VERSION = 1
_ARRAYS_FILE = "arrays.npz"
_META_FILE = "meta.json"


class UnsupportedOperation(NotImplementedError):
    """A capability-gated operation was called on a backend lacking it."""


class Searcher(abc.ABC):
    """Backend-agnostic index handle: build -> search -> (mutate) -> save."""

    name: ClassVar[str]
    capabilities: ClassVar[Capabilities] = Capabilities()

    # re-stamped by the registry's build() and load(); the defaults keep a
    # directly constructed or from_state()-restored adapter usable
    guarantee: GuaranteeConfig = GuaranteeConfig()
    seed: int = 0
    build_seconds: float = 0.0

    # -- construction --------------------------------------------------------
    @classmethod
    @abc.abstractmethod
    def build(cls, x: np.ndarray, *, guarantee: GuaranteeConfig, seed: int,
              page_bytes: int, **opts) -> "Searcher":
        """Build an index over ``x`` ((n, d) float32) under ``guarantee``."""

    # -- search --------------------------------------------------------------
    @abc.abstractmethod
    def _search(self, queries, k: int, **opts
                ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Backend core: (B, d) queries -> (ids (B,k), scores (B,k), stats)."""

    def search(self, queries, k: Optional[int] = None, **opts) -> SearchResult:
        """Batched c-k-AMIP search. ``queries``: (B, d) or a single (d,) row.

        ``k`` defaults to the guarantee's k. Extra ``opts`` go to the backend
        (``runtime=RuntimeConfig(...)`` on the ProMIPS family); an option it
        does not understand raises TypeError. Malformed queries (NaN/Inf in
        host arrays, non-float tensors, wrong rank or dimension) raise
        ValueError here.
        """
        q = self._validate_queries(queries)
        k = int(self.guarantee.k if k is None else k)
        if k < 1:
            raise ValueError(f"k must be a positive int, got {k!r}")
        t0 = time.perf_counter()
        ids, scores, stats = self._search(q, k, **opts)
        stats = dict(stats)
        stats.setdefault("queries", q.shape[0])
        stats["wall_time_s"] = time.perf_counter() - t0
        return SearchResult(ids=ids, scores=scores, stats=stats)

    def _validate_queries(self, queries):
        """Boundary validation shared by every backend. Tensors are checked
        on static properties only (dtype, rank, trailing dim): a finiteness
        check would cost a device sync per decode step."""
        d = self.dim
        if isinstance(queries, torch.Tensor):
            if not queries.is_floating_point():
                raise ValueError(
                    f"queries must be floating point, got dtype "
                    f"{queries.dtype} (cast activations before search)")
            if queries.dim() not in (1, 2):
                raise ValueError(f"queries must be (B, d) or (d,), got "
                                 f"shape {tuple(queries.shape)}")
            q = queries if queries.dim() == 2 else queries[None, :]
        else:
            try:
                q = np.atleast_2d(np.asarray(queries, np.float32))
            except (TypeError, ValueError) as e:
                raise ValueError(f"queries are not castable to float32: {e}")
            if q.ndim != 2:
                raise ValueError(f"queries must be (B, d) or (d,), got "
                                 f"shape {np.asarray(queries).shape}")
            if not np.isfinite(q).all():
                bad = int(np.sum(~np.isfinite(q)))
                raise ValueError(
                    f"queries contain {bad} non-finite value(s) (NaN/Inf); "
                    "a NaN scores -inf against every row and silently "
                    "returns garbage neighbors — rejecting at the boundary")
        if d is not None and q.shape[1] != d:
            raise ValueError(f"queries have dimension {q.shape[1]}, index "
                             f"has dimension {d}")
        return q

    # -- capability-gated mutation surface -----------------------------------
    def _require_mutation(self, op: str) -> None:
        if not self.capabilities.supports_mutation:
            raise UnsupportedOperation(
                f"backend {self.name!r} does not support {op}() "
                "(capabilities.supports_mutation=False)")

    def insert(self, ids, rows) -> None:
        self._require_mutation("insert")
        raise NotImplementedError  # pragma: no cover - adapter must override

    def delete(self, ids) -> None:
        self._require_mutation("delete")
        raise NotImplementedError  # pragma: no cover

    def update(self, ids, rows) -> None:
        self._require_mutation("update")
        raise NotImplementedError  # pragma: no cover

    def alive_items(self):
        """(gids, rows) of every live row."""
        self._require_mutation("alive_items")
        raise NotImplementedError  # pragma: no cover

    def flush(self, timeout: Optional[float] = None) -> None:
        """Wait for background maintenance (compaction); default no-op."""

    # -- introspection -------------------------------------------------------
    @property
    @abc.abstractmethod
    def n(self) -> int:
        """Number of (live) indexed rows."""

    @property
    @abc.abstractmethod
    def index_bytes(self) -> int:
        """In-memory index size."""

    @property
    def dim(self) -> Optional[int]:
        """Row dimensionality, for boundary validation; None = unknown."""
        return None

    # -- persistence ---------------------------------------------------------
    @abc.abstractmethod
    def state(self) -> Tuple[dict, dict]:
        """(arrays, meta): host numpy arrays for ``arrays.npz`` (the index's
        host copy, never its device tensors) and a JSON-able backend meta
        dict, in the JAX package's layout. Together they must rebuild a
        searcher whose searches are bit-identical to this one's."""

    @classmethod
    @abc.abstractmethod
    def from_state(cls, arrays: dict, meta: dict,
                   device="cuda") -> "Searcher":
        """Inverse of :meth:`state`, the index on ``device``."""

    def save(self, path: str) -> str:
        """Persist to ``path`` (a directory): arrays.npz + meta.json +
        manifest.json, written atomically (temp dir + rename) with per-file
        SHA256 checksums; a crash mid-save leaves the previous snapshot
        intact."""
        arrays, backend_meta = self.state()
        header = {
            "format": FORMAT_NAME,
            "version": FORMAT_VERSION,
            "backend": self.name,
            "seed": int(self.seed),
            "guarantee": dataclasses.asdict(self.guarantee),
            "backend_meta": backend_meta,
        }

        def _write_meta(p):
            with open(p, "w") as f:
                json.dump(header, f, indent=1)

        write_atomic_dir(path, {
            _ARRAYS_FILE: lambda p: np.savez_compressed(p, **arrays),
            _META_FILE: _write_meta,
        }, manifest_extra={"format": FORMAT_NAME,
                           "version": FORMAT_VERSION})
        return path

    @classmethod
    def load(cls, path: str, device="cuda") -> "Searcher":
        """The searcher saved at ``path`` (verified against its manifest),
        its index on ``device``."""
        device = resolve_device(device)
        header = read_header(path)
        if header["backend"] != cls.name:
            raise ValueError(f"index at {path!r} was saved by backend "
                             f"{header['backend']!r}, not {cls.name!r} "
                             "(use repro_torch.api.load to dispatch)")
        with np.load(os.path.join(path, _ARRAYS_FILE)) as z:
            arrays = {key: z[key] for key in z.files}
        obj = cls.from_state(arrays, header["backend_meta"], device=device)
        obj.guarantee = GuaranteeConfig(**header["guarantee"])
        obj.seed = int(header["seed"])
        obj.build_seconds = 0.0
        return obj


def saved_bytes(path: str) -> int:
    """On-disk footprint of a saved index directory."""
    total = 0
    for root, _dirs, files in os.walk(path):
        total += sum(os.path.getsize(os.path.join(root, f)) for f in files)
    return total


def read_header(path: str) -> dict:
    """Parse and validate the ``meta.json`` header of a saved index.

    Integrity first: every manifest-listed file is re-hashed and a mismatch
    raises `CorruptSnapshotError` naming the failing file (a manifest-less
    directory loads unverified, with a warning)."""
    meta_path = os.path.join(path, _META_FILE)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no saved index at {path!r} "
                                f"(missing {_META_FILE})")
    verify_dir(path)
    with open(meta_path) as f:
        header = json.load(f)
    if header.get("format") != FORMAT_NAME:
        raise ValueError(f"{meta_path}: not a {FORMAT_NAME} file")
    if header.get("version") != FORMAT_VERSION:
        raise ValueError(f"{meta_path}: format version "
                         f"{header.get('version')!r} != {FORMAT_VERSION}")
    return header


__all__ = ["Searcher", "UnsupportedOperation", "CorruptSnapshotError",
           "read_header", "saved_bytes", "FORMAT_NAME", "FORMAT_VERSION"]
