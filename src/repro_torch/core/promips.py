"""ProMIPS handle: build an index on the host, keep its arrays on one device
and search them; port of the device-search part of `repro.core.promips`.

>>> pm = ProMIPS.build(x, m=16, c=0.9, p=0.6, norm_strata=8, seed=0)
>>> ids, scores, stats = pm.search(queries, k=10, prefilter=True,
...                                prefilter_eps=0.1, dense_frac=0.8)

Both run on the card unless ``device="cpu"`` is passed to `build`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .index import (IndexArrays, IndexMeta, ProMIPSIndex, build_index,
                    resolve_device, to_device)
from .runtime import RuntimeConfig
from .runtime import search as runtime_search


class ProMIPS:
    """Owns one built index and its arrays on ``device``."""

    def __init__(self, index: ProMIPSIndex, device="cuda"):
        self.index = index
        self.device = resolve_device(device)
        self.arrays: IndexArrays = to_device(index.arrays, self.device)

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

    def search(self, queries, k: int = 10, budget: Optional[int] = None,
               budget2: Optional[int] = None, norm_adaptive: bool = False,
               cs_prune: bool = False, prefilter: bool = False,
               prefilter_eps: float = 1.0, dense_frac: Optional[float] = None,
               tile_cap: Optional[int] = None):
        """Batched two-phase c-k-AMIP search with fused verification.
        queries: (B, d). Returns (ids (B, k), scores (B, k), SearchStats)."""
        cfg = RuntimeConfig(k=k, budget=budget, budget2=budget2,
                            norm_adaptive=norm_adaptive, cs_prune=cs_prune,
                            prefilter=prefilter, prefilter_eps=prefilter_eps,
                            dense_frac=dense_frac, tile_cap=tile_cap)
        return runtime_search(self.arrays, self.meta, queries, cfg,
                              device=self.device)


__all__ = ["ProMIPS", "ProMIPSIndex", "IndexArrays", "IndexMeta"]
