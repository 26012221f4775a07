"""Shared value types of the index API; copy of `repro.api.types`.

The paper's user contract is declarative: "return c-AMIP results with
probability >= p0" (Theorems 1-2). `GuaranteeConfig` captures exactly that
triple — (c, p0, k) — and *derives* the internal knobs (projected dimension
m via the Section V-B cost model, the chi-square radius threshold
x_p = Psi_m^{-1}(p0), Quick-Probe scan budgets) so callers never pick raw
budgets. `SearchResult` is the one return type every registered backend
produces; `Capabilities` is the static feature matrix that gates the
mutation / sharding / guarantee surfaces.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.chi2 import chi2_ppf_host
from ..core.dim_opt import optimized_projected_dimension, quick_probe_cost


@dataclass(frozen=True)
class Capabilities:
    """Static feature flags of one backend (checked, not duck-typed)."""

    supports_mutation: bool = False   # insert/delete/update after build
    supports_sharding: bool = False   # corpus split over multiple sub-indexes
    guaranteed: bool = False          # honors the (c, p0) probability contract
    prefilter: bool = False           # quantized-sketch block prefilter
                                      # (RuntimeConfig.prefilter / eps knob)


@dataclass(frozen=True)
class GuaranteePlan:
    """Everything `GuaranteeConfig.derive` computed from (c, p0, n).

    ``budget``/``budget2`` are None — "scan every selected block" — because
    any finite truncation voids the Theorem-2 probability bound; they exist
    so a caller who *knowingly* trades the guarantee for latency has a
    single place to override.
    """

    m: int                    # projected dimension m* (Section V-B argmin)
    x_p: float                # Psi_m^{-1}(p0): the static radius threshold
    probe_cost: float         # Quick-Probe cost 2^m (m+1) + n / 2^m at m*
    probe_groups: int         # group-scan budget: at most 2^m groups exist
    budget: Optional[int] = None
    budget2: Optional[int] = None


@dataclass(frozen=True)
class GuaranteeConfig:
    """Guarantee-first build/search configuration: the paper's (c, p0, k).

    c  — approximation ratio of the c-AMIP contract (0 < c <= 1).
    p0 — success probability: P[returned o has <o,q> >= c * <o*,q>] >= p0.
    k  — results per query.

    Backends that set `Capabilities.guaranteed` derive every internal knob
    from this (see :meth:`derive`); the others receive it for (c, p0)-aware
    tuning but cannot promise the bound.
    """

    c: float = 0.9
    p0: float = 0.5
    k: int = 10

    def __post_init__(self):
        if not 0.0 < self.c <= 1.0:
            raise ValueError(f"c must be in (0, 1], got {self.c!r}")
        if not 0.0 < self.p0 < 1.0:
            raise ValueError(f"p0 must be in (0, 1), got {self.p0!r}")
        if not isinstance(self.k, (int, np.integer)) or self.k < 1:
            raise ValueError(f"k must be a positive int, got {self.k!r}")

    def derive(self, n: int) -> GuaranteePlan:
        """Derive the internal knobs for a corpus of ``n`` points.

        m* minimizes the Quick-Probe cost model f(m) = 2^m (m+1) + n / 2^m
        (`core/dim_opt`, paper Section V-B); x_p = Psi_m^{-1}(p0) is the
        compile-time chi-square threshold every radius computation
        (Conditions B, Test A, compensation radius) is driven by.
        """
        m = min(optimized_projected_dimension(max(int(n), 1)), 30)
        return GuaranteePlan(
            m=m,
            x_p=float(chi2_ppf_host(self.p0, m)),
            probe_cost=quick_probe_cost(m, int(n)),
            probe_groups=2 ** m,
            budget=None,
            budget2=None,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# Normalized stats contract: every backend's SearchResult.stats carries
# exactly these keys (the stats types' to_dict() produce the first four;
# the facade stamps wall_time_s).
STAT_KEYS = ("pages", "candidates", "exhausted", "queries", "wall_time_s")


@dataclass
class SearchResult:
    """Uniform result of one batched search across every backend.

    ids    — (B, k) int64 global ids (-1 = empty slot).
    scores — (B, k) float32 exact inner products, descending per row.
    stats  — normalized accounting dict (STAT_KEYS): total logical page
             accesses, total verified candidates, number of
             budget-exhausted queries, query count, and wall time.
    """

    ids: np.ndarray
    scores: np.ndarray
    stats: dict = field(default_factory=dict)

    def __post_init__(self):
        self.ids = np.asarray(self.ids, np.int64)
        self.scores = np.asarray(self.scores, np.float32)

    @property
    def pages(self) -> int:
        return int(self.stats.get("pages", 0))

    @property
    def candidates(self) -> int:
        return int(self.stats.get("candidates", 0))

    @property
    def wall_time_s(self) -> float:
        return float(self.stats.get("wall_time_s", 0.0))

    def to_dict(self) -> dict:
        """JSON-able summary (benchmark emitters)."""
        return {"ids": self.ids.tolist(), "scores": self.scores.tolist(),
                "stats": dict(self.stats)}


__all__ = ["Capabilities", "GuaranteeConfig", "GuaranteePlan", "SearchResult",
           "STAT_KEYS"]
