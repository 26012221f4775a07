"""Registered backends of the port: ``promips-stream`` (the mutable
streaming index, `stream.MutableProMIPS`), the one the serve engine builds;
port of that part of `repro.api.adapters`. The immutable ``promips``,
``sharded`` and the baselines are ROADMAP Queue 1 item 6.

The ProMIPS family derives m from the `GuaranteeConfig` (the Section V-B
cost model, unless the caller gives ``m``) and x_p = Psi_m^{-1}(p0) inside
`build_index` from the same (c, p0).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.runtime import RuntimeConfig
from ..stream.mutable import MutableProMIPS
from ..tune import cache as tune_cache
from .base import Searcher
from .registry import register
from .types import Capabilities, GuaranteeConfig


def _runtime_from_opts(guarantee: GuaranteeConfig, mode: str,
                       verification: Optional[str],
                       norm_adaptive: Optional[bool],
                       cs_prune: Optional[bool], budget, budget2,
                       prefilter: bool = False,
                       prefilter_eps: Optional[float] = None,
                       obs: bool = False, *, shape: tuple,
                       device) -> RuntimeConfig:
    """Map facade opts onto a `RuntimeConfig` with guarantee-safe defaults:
    budgets stay None (scan every selected block; the Theorem-2 bound needs
    no truncation) unless the caller trades them. ``verification=None`` and
    ``prefilter_eps=None`` consult the tuning cache for the ``shape=(n, d)``
    point on ``device`` and fall back to the hand-picked "fused" and 1.0 (the
    lossless sketch bound) on a miss, as the JAX package's facade does."""
    if mode == "progressive":
        norm_adaptive = True if norm_adaptive is None else norm_adaptive
        cs_prune = True if cs_prune is None else cs_prune
    if verification is None or prefilter_eps is None:
        tuned = tune_cache.resolved("runtime", *shape, device=device)
        if verification is None:
            verification = str(tuned["verification"])
        if prefilter_eps is None:
            # a tuned eps only describes a prefiltered workload; with the
            # prefilter off the knob is dead and stays at lossless 1.0
            prefilter_eps = (float(tuned["prefilter_eps"]) if prefilter
                             else 1.0)
    return RuntimeConfig(
        k=guarantee.k, budget=budget, budget2=budget2, mode=mode,
        verification=verification,
        norm_adaptive=bool(norm_adaptive) if norm_adaptive is not None else False,
        cs_prune=bool(cs_prune) if cs_prune is not None else False,
        prefilter=bool(prefilter), prefilter_eps=float(prefilter_eps),
        obs=bool(obs))


class _MutableMixin:
    """Forwarders for the mutation contract (inner = stream-family object)."""

    def insert(self, ids, rows) -> None:
        self.inner.insert(ids, rows)

    def delete(self, ids) -> None:
        self.inner.delete(ids)

    def update(self, ids, rows) -> None:
        self.inner.update(ids, rows)

    def alive_items(self):
        return self.inner.alive_items()

    def compact(self) -> None:
        self.inner.compact()

    @property
    def n(self) -> int:
        return self.inner.n_alive

    @property
    def dim(self) -> int:
        return self.inner.d


@register
class StreamSearcher(_MutableMixin, Searcher):
    """Streaming ProMIPS (base + delta segments, tombstones, compaction)."""

    name = "promips-stream"
    capabilities = Capabilities(guaranteed=True, supports_mutation=True,
                                prefilter=True)

    def __init__(self, stream: MutableProMIPS, runtime: RuntimeConfig):
        self.inner = stream
        self.runtime = runtime

    @classmethod
    def build(cls, x, *, guarantee, seed, page_bytes, ids=None, m=None,
              mode="two_phase", verification=None, norm_adaptive=None,
              cs_prune=None, budget=None, budget2=None, norm_strata=1,
              prefilter=False, prefilter_eps=None, obs=False,
              delta_capacity=None, auto_compact=False, device="cuda",
              **index_opts) -> "StreamSearcher":
        plan = guarantee.derive(len(x))
        stream = MutableProMIPS(
            x, ids=ids, delta_capacity=delta_capacity,
            auto_compact=auto_compact, device=device,
            m=plan.m if m is None else int(m), c=guarantee.c, p=guarantee.p0,
            page_bytes=page_bytes, seed=seed, norm_strata=int(norm_strata),
            **index_opts)
        return cls(stream, _runtime_from_opts(
            guarantee, mode, verification, norm_adaptive, cs_prune, budget,
            budget2, prefilter, prefilter_eps, obs,
            shape=(len(x), int(x.shape[1])), device=stream.device))

    def _search(self, queries, k, runtime: Optional[RuntimeConfig] = None
                ) -> Tuple[np.ndarray, np.ndarray, dict]:
        cfg = self.runtime if runtime is None else runtime
        ids, scores, stats = self.inner.search(queries, k=k, runtime=cfg)
        return ids.cpu().numpy(), scores.cpu().numpy(), stats.to_dict()

    def flush(self, timeout=None) -> None:
        self.inner.join_compaction(timeout)

    def maintenance_status(self) -> dict:
        """Compaction + WAL health for the serve engine's `health()`."""
        comp = (self.inner.compactor.status()
                if self.inner.compactor is not None else None)
        return {"compaction": comp, "wal_attached": self.inner._wal is not None,
                "wal_lag": self.inner.wal_lag()}

    @property
    def index_bytes(self) -> int:
        base = self.inner.meta.index_bytes
        delta = self.inner._delta
        return base + delta.x.nbytes + delta.gids.nbytes + delta.alive.nbytes


__all__ = ["StreamSearcher"]
