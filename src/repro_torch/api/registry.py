"""Backend registry: names -> `Searcher` classes, and the `build(x,
backend=...)` entry point; port of `repro.api.registry` (without `load`,
which waits for the snapshot format, ROADMAP Queue 1 item 8)."""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple, Type

import numpy as np

from ..core.index import resolve_device
from ..tune import cache as tune_cache
from .base import Searcher, UnsupportedOperation
from .types import Capabilities, GuaranteeConfig

_REGISTRY: Dict[str, Type[Searcher]] = {}

# backends of the JAX package the port has not taken yet
NOT_PORTED = ("exact", "h2alsh", "pq", "promips", "rangelsh", "sharded")


def register(cls: Type[Searcher]) -> Type[Searcher]:
    """Class decorator: add a `Searcher` subclass under ``cls.name``."""
    name = getattr(cls, "name", None)
    if not name or not isinstance(name, str):
        raise ValueError(f"{cls!r} must define a string `name`")
    if not isinstance(getattr(cls, "capabilities", None), Capabilities):
        raise ValueError(f"{cls!r} must define `capabilities`")
    _REGISTRY[name] = cls
    return cls


def backends() -> Tuple[str, ...]:
    """Registered backend names, sorted."""
    return tuple(sorted(_REGISTRY))


def get_backend(name: str) -> Type[Searcher]:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in NOT_PORTED:
            raise UnsupportedOperation(
                f"backend {name!r} is not ported yet (ROADMAP Queue 1 item "
                f"6); registered: {', '.join(backends())}") from None
        raise ValueError(f"unknown backend {name!r}; registered backends: "
                         f"{', '.join(backends())}") from None


def build(x: np.ndarray, backend: str = "promips", *,
          guarantee: Optional[GuaranteeConfig] = None,
          seed: int = 0, page_bytes: Optional[int] = None,
          wal_dir: Optional[str] = None, device="cuda",
          **opts) -> Searcher:
    """Build an index over ``x`` with the named backend, its search on
    ``device`` (the card by default; pass ``device="cpu"`` for the plain
    path).

    ``guarantee`` is the declarative contract (c, p0, k); ``seed`` makes the
    build reproducible; ``opts`` are backend-specific (e.g. ``m=8``,
    ``norm_strata=4``). ``page_bytes=None`` consults the tuning cache for
    this data shape on ``device`` and takes the hand-picked 4096 on a miss.
    ``wal_dir`` raises until the write-ahead
    log is ported (ROADMAP Queue 1 item 8).
    """
    cls = get_backend(backend)
    if wal_dir is not None:
        raise UnsupportedOperation(
            "wal_dir= needs the write-ahead log, which is not ported yet "
            "(ROADMAP Queue 1 item 8)")
    guarantee = GuaranteeConfig() if guarantee is None else guarantee
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got shape {x.shape}")
    if page_bytes is None:
        page_bytes = int(tune_cache.resolved(
            "build", x.shape[0], x.shape[1],
            device=resolve_device(device))["page_bytes"])
    t0 = time.perf_counter()
    searcher = cls.build(x, guarantee=guarantee, seed=int(seed),
                         page_bytes=int(page_bytes), device=device, **opts)
    searcher.guarantee = guarantee
    searcher.seed = int(seed)
    searcher.build_seconds = time.perf_counter() - t0
    return searcher


__all__ = ["register", "backends", "get_backend", "build"]
