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
package. `save` / `load` (checksummed snapshot directories, with the
``state()`` / ``from_state()`` pair behind them) are not ported yet and
raise (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import abc
import time
from typing import ClassVar, Optional, Tuple

import numpy as np
import torch

from .types import Capabilities, GuaranteeConfig, SearchResult


class UnsupportedOperation(NotImplementedError):
    """A capability-gated or not yet ported operation was called."""


class Searcher(abc.ABC):
    """Backend-agnostic index handle: build -> search -> (mutate)."""

    name: ClassVar[str]
    capabilities: ClassVar[Capabilities] = Capabilities()

    # re-stamped by `registry.build`; the defaults keep a directly
    # constructed adapter usable
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
    def save(self, path: str) -> str:
        raise UnsupportedOperation(
            "save() writes checksummed snapshot directories, which are not "
            "ported yet (ROADMAP Queue 1 item 8)")

    @classmethod
    def load(cls, path: str) -> "Searcher":
        raise UnsupportedOperation(
            "load() reads checksummed snapshot directories, which are not "
            "ported yet (ROADMAP Queue 1 item 8); `convert.stream_from_dir` "
            "and `convert.index_from_dir` read a JAX save directory")


__all__ = ["Searcher", "UnsupportedOperation"]
