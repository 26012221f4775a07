"""ProMIPS handle: build an index on the host, keep its arrays on one device
and search them; port of `repro.core.promips`.

>>> pm = ProMIPS.build(x, m=16, c=0.9, p=0.6, norm_strata=8, seed=0)
>>> ids, scores, stats = pm.search(queries, k=10)          # device, two-phase
>>> ids, scores, stats = pm.search_progressive(queries)    # device, progressive
>>> ids, scores, hstats = pm.search_host(q, k=10)          # the paper's search

The device searches run on the card unless ``device="cpu"`` is passed to
`build`; the host searches (`search_host`, `search_host_progressive`,
`search_incremental`) are numpy over the host build's arrays, through a
`HostSearcher` made at the first such call.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .index import (IndexArrays, IndexMeta, ProMIPSIndex, build_index,
                    resolve_device, to_device)
from .runtime import RuntimeConfig
from .runtime import search as runtime_search
from .search_host import HostSearcher, HostStats


class ProMIPS:
    """Owns one built index (host arrays) and its arrays on ``device``."""

    def __init__(self, index: ProMIPSIndex, device="cuda"):
        self.index = index
        self.device = resolve_device(device)
        self.arrays: IndexArrays = to_device(index.arrays, self.device)
        self._host: Optional[HostSearcher] = None

    @classmethod
    def build(cls, x: np.ndarray, *, seed: int = 0, device="cuda",
              **build_kwargs) -> "ProMIPS":
        """Build the index over ``x`` (n, d) on the host (the same rows and
        seed give the JAX package's arrays bit for bit) and move it to
        ``device``."""
        resolve_device(device)  # fail before the host build, not after it
        return cls(build_index(x, seed=seed, **build_kwargs), device=device)

    @property
    def meta(self) -> IndexMeta:
        return self.index.meta

    @property
    def host(self) -> HostSearcher:
        """The host searcher over this index, made at first use."""
        if self._host is None:
            self._host = HostSearcher(self.index)
        return self._host

    # -- device searches (through the runtime) ------------------------------
    def search(self, queries, k: int = 10, budget: Optional[int] = None,
               budget2: Optional[int] = None, norm_adaptive: bool = False,
               cs_prune: bool = False, verification: str = "fused",
               prefilter: bool = False, prefilter_eps: float = 1.0,
               obs: bool = False, dense_frac: Optional[float] = None,
               tile_cap: Optional[int] = None):
        """Batched two-phase c-k-AMIP search. queries: (B, d).

        ``verification``: "fused" (block-sparse rounds over the
        `block_mips` kernel), "batched" (one union tile a round through
        `mips_score`) or "scan" (each query's own block walk,
        `scan_blocks`); identical at full budget. ``obs=True`` records this
        call's spans. Returns (ids (B, k), scores (B, k), SearchStats)."""
        cfg = RuntimeConfig(k=k, budget=budget, budget2=budget2,
                            mode="two_phase", verification=verification,
                            norm_adaptive=norm_adaptive, cs_prune=cs_prune,
                            prefilter=prefilter, prefilter_eps=prefilter_eps,
                            obs=obs, dense_frac=dense_frac, tile_cap=tile_cap)
        return runtime_search(self.arrays, self.meta, queries, cfg,
                              device=self.device)

    def search_progressive(self, queries, k: int = 10,
                           budget: Optional[int] = None, cs_prune: bool = True):
        """Batched progressive search (norm-adaptive frontier)."""
        cfg = RuntimeConfig(k=k, budget=budget, mode="progressive",
                            cs_prune=cs_prune)
        return runtime_search(self.arrays, self.meta, queries, cfg,
                              device=self.device)

    # -- host searches (numpy, one query) -----------------------------------
    def search_host(self, q: np.ndarray, k: int = 10, c: float | None = None,
                    p: float | None = None, norm_adaptive: bool = False,
                    cs_prune: bool = False):
        """The paper's single-query search (Algorithms 2+3)."""
        return self.host.search(q, k=k, c=c, p=p, norm_adaptive=norm_adaptive,
                                cs_prune=cs_prune)

    def search_host_progressive(self, q: np.ndarray, k: int = 10,
                                c: float | None = None, p: float | None = None,
                                cs_prune: bool = True):
        """Single-query progressive search on the host."""
        return self.host.search_progressive(q, k=k, c=c, p=p,
                                            cs_prune=cs_prune)

    def search_incremental(self, q: np.ndarray, k: int = 10,
                           c: float | None = None, p: float | None = None):
        """The paper's Algorithm 1 (MIP-Search-I) baseline."""
        return self.host.search_incremental(q, k=k, c=c, p=p)


__all__ = ["ProMIPS", "ProMIPSIndex", "IndexArrays", "IndexMeta", "HostStats"]
