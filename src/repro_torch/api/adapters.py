"""Registered backends of the port; port of `repro.api.adapters`:

  promips         core.promips.ProMIPS through the runtime (two-phase fused
                  verification by default; opts select mode="progressive",
                  norm_adaptive, cs_prune, verification="batched"/"scan"),
                  or with ``search_path="host"`` the paper's numpy search
  promips-stream  stream.MutableProMIPS (mutation + compaction, the
                  write-ahead log), the one the serve engine builds
  sharded         core.sharded.MutableShardedProMIPS (range-routed shards,
                  mutation, host-side k x shards merge)
  exact           baselines.ExactMIPS (ground-truth full scan)
  h2alsh          baselines.H2ALSH
  pq              baselines.PQBased
  rangelsh        baselines.RangeLSH

The ProMIPS family derives m from the
`GuaranteeConfig` (the Section V-B cost model, unless the caller gives
``m``) and x_p = Psi_m^{-1}(p0) inside `build_index` from the same (c, p0);
the baselines take (c, p0) as tuning hints only and compute on the host,
as in the JAX package. Every adapter's `state()` is the JAX adapter's, so
a directory saved by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..baselines import ExactMIPS, H2ALSH, PQBased, RangeLSH
from ..core.index import IndexArrays, IndexMeta, ProMIPSIndex
from ..core.promips import ProMIPS
from ..core.runtime import RuntimeConfig
from ..core.runtime import search as runtime_search
from ..core.sharded import MutableShardedProMIPS
from ..robust.wal import WriteAheadLog
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


def _runtime_state(cfg: RuntimeConfig) -> dict:
    """A `RuntimeConfig` as the JAX package saves one: its ``use_pallas``
    field carries ``use_kernels`` (None: the kernels where the device has
    them)."""
    state = dataclasses.asdict(cfg)
    state["use_pallas"] = state.pop("use_kernels")
    return state


def _runtime_from_state(state: dict) -> RuntimeConfig:
    """Inverse of `_runtime_state`; reads either package's saves."""
    state = dict(state)
    if "use_pallas" in state:
        state["use_kernels"] = state.pop("use_pallas")
    return RuntimeConfig(**state)


def _host_queries(queries) -> np.ndarray:
    """Queries as a float32 numpy batch for the host engines."""
    if isinstance(queries, torch.Tensor):
        queries = queries.detach().cpu().numpy()
    return np.asarray(queries, np.float32)


@register
class PromipsSearcher(Searcher):
    """Immutable ProMIPS index.

    ``search_path="device"`` (default) runs the runtime (`core.runtime.
    search`) on the index's device; ``search_path="host"`` runs the
    paper's sequential numpy search (`HostSearcher`) with its exact
    resident-4KB-page accounting.
    """

    name = "promips"
    capabilities = Capabilities(guaranteed=True, prefilter=True)

    def __init__(self, pm: ProMIPS, runtime: RuntimeConfig,
                 search_path: str = "device"):
        if search_path not in ("device", "host"):
            raise ValueError(f"unknown search_path {search_path!r}; valid "
                             "choices: device, host")
        self.pm = pm
        self.runtime = runtime
        self.search_path = search_path

    @classmethod
    def build(cls, x, *, guarantee, seed, page_bytes, m=None,
              mode="two_phase", verification=None, norm_adaptive=None,
              cs_prune=None, budget=None, budget2=None, norm_strata=None,
              prefilter=False, prefilter_eps=None, obs=False,
              search_path="device", device="cuda",
              **index_opts) -> "PromipsSearcher":
        plan = guarantee.derive(len(x))
        if norm_strata is None:
            # the progressive mode's adaptive radii need norm-homogeneous
            # sub-partitions to bite
            norm_strata = 4 if mode == "progressive" else 1
        pm = ProMIPS.build(x, m=plan.m if m is None else int(m),
                           c=guarantee.c, p=guarantee.p0,
                           page_bytes=page_bytes, seed=seed,
                           norm_strata=int(norm_strata), device=device,
                           **index_opts)
        return cls(pm, _runtime_from_opts(
            guarantee, mode, verification, norm_adaptive, cs_prune, budget,
            budget2, prefilter, prefilter_eps, obs,
            shape=(len(x), int(x.shape[1])), device=pm.device), search_path)

    def _search_host(self, queries, k, cfg: RuntimeConfig
                     ) -> Tuple[np.ndarray, np.ndarray, dict]:
        queries = _host_queries(queries)
        ids = np.full((len(queries), k), -1, np.int64)
        scores = np.full((len(queries), k), -np.inf, np.float32)
        pages = candidates = exhausted = 0
        for i, q in enumerate(queries):
            if cfg.mode == "progressive":
                qi, qs, st = self.pm.search_host_progressive(
                    q, k=k, cs_prune=cfg.cs_prune)
            else:
                qi, qs, st = self.pm.search_host(
                    q, k=k, norm_adaptive=cfg.norm_adaptive,
                    cs_prune=cfg.cs_prune)
            ids[i], scores[i] = qi, qs
            d = st.to_dict()
            pages += d["pages"]
            candidates += d["candidates"]
            exhausted += d["exhausted"]
        return ids, scores, {"pages": pages, "candidates": candidates,
                             "exhausted": exhausted, "queries": len(queries)}

    def _search(self, queries, k, runtime: Optional[RuntimeConfig] = None
                ) -> Tuple[np.ndarray, np.ndarray, dict]:
        cfg = dataclasses.replace(self.runtime if runtime is None else runtime,
                                  k=k)
        if self.search_path == "host":
            return self._search_host(queries, k, cfg)
        ids, scores, stats = runtime_search(self.pm.arrays, self.pm.meta,
                                            queries, cfg, device=self.pm.device)
        return ids.cpu().numpy(), scores.cpu().numpy(), stats.to_dict()

    @property
    def n(self) -> int:
        return self.pm.meta.n

    @property
    def dim(self) -> int:
        return self.pm.meta.d

    @property
    def index_bytes(self) -> int:
        return self.pm.meta.index_bytes

    def state(self) -> Tuple[dict, dict]:
        """(arrays, meta) as the JAX adapter's: the host arrays by field,
        and the index meta, runtime settings and search path."""
        arrays = {f: np.asarray(getattr(self.pm.index.arrays, f))
                  for f in IndexArrays._fields}
        return arrays, dict(meta=dataclasses.asdict(self.pm.meta),
                            runtime=_runtime_state(self.runtime),
                            search_path=self.search_path)

    @classmethod
    def from_state(cls, arrays, meta, device="cuda") -> "PromipsSearcher":
        """The searcher of a `state()` pair (either package's), its arrays on
        ``device``."""
        names = {f.name for f in dataclasses.fields(IndexMeta)}
        index = ProMIPSIndex(
            arrays=IndexArrays(**{f: np.asarray(arrays[f])
                                  for f in IndexArrays._fields}),
            meta=IndexMeta(**{k: v for k, v in meta["meta"].items()
                              if k in names}),
            layout=None)
        return cls(ProMIPS(index, device=device),
                   _runtime_from_state(meta["runtime"]),
                   meta.get("search_path", "device"))


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

    # -- durability (robust/wal.py) ------------------------------------------
    def enable_wal(self, wal_dir: str, fsync: str = "os") -> str:
        """Make this index crash-safe: write an initial checksummed snapshot
        under ``wal_dir/snapshot`` and attach a write-ahead log at
        ``wal_dir/wal.log``; every later acknowledged mutation is logged
        before it is applied. `repro_torch.robust.recover(wal_dir)` restores
        the exact state after a crash."""
        self.flush()
        self.save(os.path.join(wal_dir, "snapshot"))
        self.inner.mark_wal_floor()
        self.inner.attach_wal(
            WriteAheadLog(os.path.join(wal_dir, "wal.log"), fsync=fsync,
                          fresh=True))
        self._wal_dir = wal_dir
        return wal_dir

    def checkpoint(self) -> str:
        """Fold the WAL into a fresh snapshot: save (atomic, checksummed),
        then truncate the log. A crash at any point is safe: the snapshot
        persists ``wal_seq`` and replay skips records at or below it, so
        dying between the save and the truncate only replays no-ops."""
        if getattr(self, "_wal_dir", None) is None:
            raise RuntimeError("no WAL attached (build with wal_dir= or "
                               "call enable_wal() first)")
        self.flush()
        self.save(os.path.join(self._wal_dir, "snapshot"))
        self.inner.mark_wal_floor()
        self.inner._wal.reset()
        return self._wal_dir

    def wal_lag(self) -> int:
        return self.inner.wal_lag()

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

    def state(self) -> Tuple[dict, dict]:
        self.flush()
        arrays, meta = self.inner.state_dict()
        return arrays, dict(meta, runtime=_runtime_state(self.runtime))

    @classmethod
    def from_state(cls, arrays, meta, device="cuda") -> "StreamSearcher":
        return cls(MutableProMIPS.from_state(arrays, meta, device=device),
                   _runtime_from_state(meta["runtime"]))


@register
class ShardedSearcher(_MutableMixin, Searcher):
    """Range-routed multi-shard streaming index (host k x shards merge)."""

    name = "sharded"
    capabilities = Capabilities(guaranteed=True, supports_mutation=True,
                                supports_sharding=True, prefilter=True)

    def __init__(self, sharded: MutableShardedProMIPS, runtime: RuntimeConfig):
        self.inner = sharded
        self.runtime = runtime

    @classmethod
    def build(cls, x, *, guarantee, seed, page_bytes, n_shards=2, m=None,
              mode="two_phase", verification=None, norm_adaptive=None,
              cs_prune=None, budget=None, budget2=None, norm_strata=1,
              prefilter=False, prefilter_eps=None, obs=False,
              delta_capacity=None, auto_compact=False, device="cuda",
              **index_opts) -> "ShardedSearcher":
        # m* and the tuned knobs follow the per-shard corpus size: each
        # shard owns its own Quick-Probe group table over ~n / n_shards rows
        n_shard = max(len(x) // max(int(n_shards), 1), 1)
        plan = guarantee.derive(n_shard)
        sharded = MutableShardedProMIPS(
            x, int(n_shards), delta_capacity=delta_capacity,
            auto_compact=auto_compact, device=device,
            m=plan.m if m is None else int(m), c=guarantee.c, p=guarantee.p0,
            page_bytes=page_bytes, seed=seed, norm_strata=int(norm_strata),
            **index_opts)
        return cls(sharded, _runtime_from_opts(
            guarantee, mode, verification, norm_adaptive, cs_prune, budget,
            budget2, prefilter, prefilter_eps, obs,
            shape=(n_shard, int(x.shape[1])),
            device=sharded.shards[0].device))

    def _search(self, queries, k, runtime: Optional[RuntimeConfig] = None
                ) -> Tuple[np.ndarray, np.ndarray, dict]:
        cfg = self.runtime if runtime is None else runtime
        ids, scores, stats = self.inner.search(queries, k=k, runtime=cfg)
        return ids, scores, stats.to_dict()

    def alive_items(self):
        gids, rows = [], []
        for shard in self.inner.shards:
            g, r = shard.alive_items()
            gids.append(g)
            rows.append(r)
        return np.concatenate(gids), np.concatenate(rows)

    def flush(self, timeout=None) -> None:
        for shard in self.inner.shards:
            shard.join_compaction(timeout)

    @property
    def dim(self) -> int:
        return self.inner.shards[0].d

    def maintenance_status(self) -> dict:
        """Per-shard compaction health rolled up worst-case (any shard's
        latched error shows in ``compaction``), the per-shard detail beside
        it; the sharded index keeps no WAL."""
        per = [s.compactor.status() if s.compactor is not None else None
               for s in self.inner.shards]
        live = [p for p in per if p is not None]
        comp = None
        if live:
            comp = {
                "in_flight": any(p["in_flight"] for p in live),
                "runs": sum(p["runs"] for p in live),
                "failures": sum(p["failures"] for p in live),
                "retries": sum(p["retries"] for p in live),
                "error_latched": any(p["error_latched"] for p in live),
                "last_error": next((p["last_error"] for p in live
                                    if p["last_error"]), None),
                "shards": per,
            }
        return {"compaction": comp, "wal_attached": False, "wal_lag": 0}

    @property
    def index_bytes(self) -> int:
        return sum(s.meta.index_bytes for s in self.inner.shards)

    def state(self) -> Tuple[dict, dict]:
        self.flush()
        arrays, meta = self.inner.state_dict()
        return arrays, dict(meta, runtime=_runtime_state(self.runtime))

    @classmethod
    def from_state(cls, arrays, meta, device="cuda") -> "ShardedSearcher":
        return cls(MutableShardedProMIPS.from_state(arrays, meta,
                                                    device=device),
                   _runtime_from_state(meta["runtime"]))


# ---------------------------------------------------------------------------
# Baselines: numpy host engines, rebuilt from raw rows + ctor kwargs + seed
# ---------------------------------------------------------------------------

class _BaselineSearcher(Searcher):
    """Shared adapter for the numpy baselines (single-query engines on the
    host). `state()` is the raw rows plus the constructor kwargs (the seed
    included); `from_state` re-runs the seeded build, which is bit for bit
    the same index."""

    inner_cls: type = None           # set by subclasses
    seeded = True                    # inner_cls accepts a ``seed`` kwarg

    def __init__(self, inner, x: np.ndarray, ctor: dict):
        self.inner = inner
        self._x = x
        self._ctor = ctor

    @classmethod
    def build(cls, x, *, guarantee, seed, page_bytes, device=None, **opts):
        # ``device`` was resolved by `registry.build`; the engine is numpy
        ctor = dict(opts, page_bytes=int(page_bytes))
        if cls.seeded:
            ctor.setdefault("seed", int(seed))
        return cls(cls.inner_cls(**ctor).build(x), x, ctor)

    def _search(self, queries, k, **_ignored
                ) -> Tuple[np.ndarray, np.ndarray, dict]:
        queries = _host_queries(queries)
        ids = np.full((len(queries), k), -1, np.int64)
        scores = np.full((len(queries), k), -np.inf, np.float32)
        pages = candidates = 0
        for i, q in enumerate(queries):
            qi, qs, st = self.inner.search(q, k=k)
            ids[i, : len(qi)] = qi
            scores[i, : len(qs)] = qs
            pages += int(st["pages"])
            candidates += int(st["candidates"])
        return ids, scores, {"pages": pages, "candidates": candidates,
                             "exhausted": 0, "queries": len(queries)}

    @property
    def n(self) -> int:
        return len(self._x)

    @property
    def dim(self) -> int:
        return int(self._x.shape[1])

    @property
    def index_bytes(self) -> int:
        return int(self.inner.index_bytes)

    def state(self) -> Tuple[dict, dict]:
        return {"x": self._x}, dict(ctor=self._ctor)

    @classmethod
    def from_state(cls, arrays, meta, device=None) -> "_BaselineSearcher":
        # ``device`` was resolved by `Searcher.load`; the engine is numpy
        x = np.ascontiguousarray(arrays["x"], np.float32)
        ctor = dict(meta["ctor"])
        return cls(cls.inner_cls(**ctor).build(x), x, ctor)


@register
class ExactSearcher(_BaselineSearcher):
    name = "exact"
    # the full scan IS the guarantee (c=1, p0=1) and pays n/page_rows pages
    capabilities = Capabilities(guaranteed=True)
    inner_cls = ExactMIPS
    seeded = False


@register
class H2ALSHSearcher(_BaselineSearcher):
    name = "h2alsh"
    capabilities = Capabilities()
    inner_cls = H2ALSH


@register
class PQSearcher(_BaselineSearcher):
    name = "pq"
    capabilities = Capabilities()
    inner_cls = PQBased


@register
class RangeLSHSearcher(_BaselineSearcher):
    name = "rangelsh"
    capabilities = Capabilities()
    inner_cls = RangeLSH


__all__ = ["PromipsSearcher", "StreamSearcher", "ShardedSearcher",
           "ExactSearcher", "H2ALSHSearcher", "PQSearcher",
           "RangeLSHSearcher"]
