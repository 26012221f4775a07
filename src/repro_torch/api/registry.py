"""Backend registry: names -> `Searcher` classes, plus the two facade entry
points `build(x, backend=...)` and `load(path)`; port of
`repro.api.registry`."""
from __future__ import annotations

import time
from typing import Dict, Iterator, Optional, Tuple, Type

import numpy as np

from ..core.index import resolve_device
from ..tune import cache as tune_cache
from .base import Searcher, read_header
from .types import Capabilities, GuaranteeConfig

_REGISTRY: Dict[str, Type[Searcher]] = {}


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
        raise ValueError(f"unknown backend {name!r}; registered backends: "
                         f"{', '.join(backends())}") from None


def iter_backends() -> Iterator[Tuple[str, Type[Searcher]]]:
    for name in backends():
        yield name, _REGISTRY[name]


def build(x: np.ndarray, backend: str = "promips", *,
          guarantee: Optional[GuaranteeConfig] = None,
          seed: int = 0, page_bytes: Optional[int] = None,
          wal_dir: Optional[str] = None, wal_fsync: str = "os",
          device="cuda", **opts) -> Searcher:
    """Build an index over ``x`` with the named backend, its search on
    ``device`` (the card by default; pass ``device="cpu"`` for the plain
    path). ``device`` is resolved before any backend builds, so the default
    raises without a card for every backend; the numpy baselines then
    compute on the host, as in the JAX package.

    ``guarantee`` is the declarative contract (c, p0, k); ``seed`` makes the
    build reproducible; ``opts`` are backend-specific (e.g. ``m=8``,
    ``norm_strata=4``, ``n_shards=4``). ``page_bytes=None`` consults the
    tuning cache for this data shape on ``device`` and takes the
    hand-picked 4096 on a miss.

    ``wal_dir`` (mutable ``promips-stream`` only) makes the index
    crash-safe: an initial checksummed snapshot plus a write-ahead log land
    under that directory, every acknowledged mutation is logged before it
    is applied, and `repro_torch.robust.recover(wal_dir)` restores the exact
    pre-crash state. ``wal_fsync`` picks the durability/latency trade
    ("always" | "os" | "never").
    """
    cls = get_backend(backend)
    device = resolve_device(device)
    guarantee = GuaranteeConfig() if guarantee is None else guarantee
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got shape {x.shape}")
    if page_bytes is None:
        page_bytes = int(tune_cache.resolved(
            "build", x.shape[0], x.shape[1], device=device)["page_bytes"])
    t0 = time.perf_counter()
    searcher = cls.build(x, guarantee=guarantee, seed=int(seed),
                         page_bytes=int(page_bytes), device=device, **opts)
    searcher.guarantee = guarantee
    searcher.seed = int(seed)
    searcher.build_seconds = time.perf_counter() - t0
    if wal_dir is not None:
        # after the guarantee/seed stamps, so that the initial snapshot's
        # header carries them
        if not hasattr(searcher, "enable_wal"):
            raise ValueError(f"backend {backend!r} does not support wal_dir= "
                             "(write-ahead logging needs a mutable "
                             "promips-stream index)")
        searcher.enable_wal(wal_dir, fsync=wal_fsync)
    return searcher


def load(path: str, device="cuda") -> Searcher:
    """Load a saved index (the port's or the JAX package's), dispatching on
    the backend recorded in meta.json; its index on ``device``."""
    header = read_header(path)
    return get_backend(header["backend"]).load(path, device=device)


__all__ = ["register", "backends", "get_backend", "iter_backends", "build",
           "load"]
