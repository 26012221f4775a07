"""Sharded ProMIPS on one device; port of `repro.core.sharded`.

Build: contiguous row ranges -> per-shard `build_index` (ids are GLOBAL
row ids), padded to common array shapes and stacked on a leading shard
axis, exactly as the JAX package pads them. Search: where the JAX package
runs each shard's `runtime.search` on its own device under ``shard_map``
and merges the k x n_shards winners with ``all_gather`` + ``top_k``, the
port runs the shards one after another on one device, each through the
port's `runtime.search` on a per-shard view of the stacked tensors (made
once, by `device_put_sharded_index`, and kept, so that the fused driver's
CUDA graphs, keyed on the tensors, are captured once a shard), and merges
with the same rule: a stable top-k over the shard-major (B, S * k)
concatenation, ties to the lower position.

`MutableShardedProMIPS` is the streaming form: one `MutableProMIPS` per
shard, writes routed by global-id range, a host merge of the per-shard
results.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import ref
from ..obs import trace as _trace
from .index import IndexArrays, IndexMeta, build_index, resolve_device, to_device
from .runtime import RuntimeConfig, _spans_on
from .runtime import search as runtime_search
from .stats import _host, stats_totals


class ShardedIndex(NamedTuple):
    arrays: IndexArrays      # every leaf has a leading (n_shards,) axis
    meta: IndexMeta          # common (max-padded) meta
    # per-shard views of ``arrays`` on one device (`device_put_sharded_index`;
    # empty while the arrays are host numpy)
    shards: Tuple[IndexArrays, ...] = ()


class ShardedStats(NamedTuple):
    """Aggregated accounting of one fan-out search (host-merge path).

    Same pages/candidates field contract as `SearchStats` / `HostStats` /
    `StreamStats` (a query counts exhausted if ANY shard exhausted on it);
    totals are pre-aggregated, so ``queries`` is carried explicitly.
    """

    pages: int
    candidates: int
    exhausted: int
    queries: int

    def to_dict(self) -> dict:
        return stats_totals(self.pages, self.candidates, self.exhausted,
                            queries=self.queries)


def _pad_to(arr: np.ndarray, n: int, fill):
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr
    width = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, width, constant_values=fill)


def build_sharded(x: np.ndarray, n_shards: int, **kwargs) -> ShardedIndex:
    """Host build of ``n_shards`` contiguous row ranges of ``x``, stacked
    (numpy; the same arrays as the JAX `build_sharded` bit for bit).
    ``kwargs`` go to `build_index`."""
    n = x.shape[0]
    bounds = np.linspace(0, n, n_shards + 1).astype(int)
    parts = []
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        idx = build_index(x[lo:hi], **kwargs)
        a = idx.arrays._replace(
            ids=np.where(idx.arrays.ids >= 0, idx.arrays.ids + lo, -1).astype(np.int32)
        )
        parts.append((a, idx.meta))

    n_pad = max(m.n_pad for _, m in parts)
    g_max = max(m.n_groups for _, m in parts)
    s_max = max(m.n_subparts for _, m in parts)
    nb_max = max(m.n_blocks for _, m in parts)
    kmax = max(a.block_sp_idx.shape[1] for a, _ in parts)
    kcb_max = max(m.sk_codewords for _, m in parts)
    page_rows = parts[0][1].page_rows

    stacked = {}
    for field in IndexArrays._fields:
        vals = []
        for a, m in parts:
            v = np.asarray(getattr(a, field))
            if field in ("x", "p", "ids", "l2sq"):
                v = _pad_to(v, n_pad, -1 if field == "ids" else 0)
            elif field.startswith("g_"):
                # zero-count groups: Quick-Probe never picks them
                v = _pad_to(v, g_max, 0)
            elif field == "sp_start":
                v = _pad_to(v, s_max + 1, v[-1])
            elif field.startswith("sp_"):
                # unreachable centers (1e30) + zero radius => never selected
                v = _pad_to(v, s_max, 1e30 if field == "sp_center" else 0)
            elif field == "block_sp_idx":
                if v.shape[1] < kmax:
                    v = np.pad(v, ((0, 0), (0, kmax - v.shape[1])), constant_values=-1)
                v = _pad_to(v, nb_max, -1)
            elif field == "sk_codebooks":
                # codeword count tracks min(256, NB_shard): pad small shards'
                # codebooks with zero codewords (never assigned by real codes)
                if v.shape[1] < kcb_max:
                    v = np.pad(v, ((0, 0), (0, kcb_max - v.shape[1]), (0, 0)))
            elif field.startswith("sk_") or field.startswith("block_"):
                # padded blocks decode to the zero sketch with err 0; the
                # prefilter drops them via the ids-derived block validity
                v = _pad_to(v, nb_max, 0)
            vals.append(v)
        stacked[field] = np.stack(vals)
    meta = dataclasses.replace(
        parts[0][1], n=n, n_pad=n_pad, n_blocks=nb_max, n_groups=g_max,
        n_subparts=s_max, page_rows=page_rows, sk_codewords=kcb_max,
    )
    return ShardedIndex(arrays=IndexArrays(**stacked), meta=meta)


def device_put_sharded_index(sharded: ShardedIndex,
                             device="cuda") -> ShardedIndex:
    """The stacked arrays as tensors on ``device`` (the card by default),
    with one `IndexArrays` view of them per shard. Keep the result: every
    search through it reuses the views (and so the fused driver's graphs)."""
    dev = resolve_device(device)
    arrays = to_device(sharded.arrays, dev)
    n_shards = arrays.x.shape[0]
    shards = tuple(IndexArrays(*(t[s] for t in arrays))
                   for s in range(n_shards))
    return ShardedIndex(arrays=arrays, meta=sharded.meta, shards=shards)


def sharded_search(
    sharded: ShardedIndex,
    queries,
    k: int,
    *,
    device="cuda",
    budget: int = 64,
    cs_prune: bool = True,
    runtime: Optional[RuntimeConfig] = None,
):
    """Global c-k-AMIP over the sharded corpus on ``device``. queries:
    (B, d). A host index (no views yet) is put on ``device`` first, which
    costs the upload on every such call: pass the result of
    `device_put_sharded_index` instead.

    ``runtime`` selects the per-shard search config (mode / verification
    backend); the default is the progressive norm-adaptive frontier with
    ``budget`` and ``cs_prune``. A given RuntimeConfig is taken as it is,
    with k stamped in. Returns (ids (B, k), scores (B, k), pages summed over
    the shards and queries).
    """
    dev = resolve_device(device)
    if not sharded.shards or sharded.arrays.x.device != dev:
        sharded = device_put_sharded_index(sharded, dev)
    meta = sharded.meta
    cfg = runtime if runtime is not None else RuntimeConfig(
        mode="progressive", cs_prune=cs_prune, budget=budget)
    cfg = dataclasses.replace(cfg, k=k)
    q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32,
                                         device=dev)).contiguous()
    with _trace.span("sharded_fanout", active=_spans_on(cfg, q),
                     metric="sharded.fanout_us") as sp:
        ids_all, scores_all, pages = [], [], 0
        for arrays in sharded.shards:
            ids, scores, stats = runtime_search(arrays, meta, q, cfg,
                                                device=dev)
            ids_all.append(ids)
            scores_all.append(scores)
            pages = pages + stats.pages.sum()
        flat_i = torch.cat(ids_all, dim=1)
        flat_s = torch.cat(scores_all, dim=1)
        best_s, pos = ref.topk_stable(flat_s, k)
        return sp.fence((flat_i.gather(1, pos), best_s, pages))


class MutableShardedProMIPS:
    """Streaming sharded index: one `stream.MutableProMIPS` per shard, writes
    routed by contiguous global-id range.

    The initial corpus is split into contiguous row ranges exactly like
    `build_sharded`; each shard owns its range's ids plus a private delta
    segment and tombstone bitmap. Ids past the initial corpus route to the
    last shard (the append range). Search runs the per-shard
    segment-merged search and merges the k x n_shards (id, score) pairs on
    the host. Every shard's tensors live on ``device``.
    """

    def __init__(self, x: np.ndarray, n_shards: int, *,
                 delta_capacity: Optional[int] = None,
                 auto_compact: bool = False, device="cuda", **build_kwargs):
        from ..stream.mutable import MutableProMIPS

        dev = resolve_device(device)
        n = x.shape[0]
        self.bounds = np.linspace(0, n, n_shards + 1).astype(int)
        self.shards = [
            MutableProMIPS(x[lo:hi], ids=np.arange(lo, hi),
                           delta_capacity=delta_capacity,
                           auto_compact=auto_compact, device=dev,
                           **build_kwargs)
            for lo, hi in zip(self.bounds[:-1], self.bounds[1:])
        ]

    @property
    def n_alive(self) -> int:
        return sum(s.n_alive for s in self.shards)

    def _route(self, gids: np.ndarray) -> np.ndarray:
        shard = np.searchsorted(self.bounds, gids, side="right") - 1
        return np.clip(shard, 0, len(self.shards) - 1)

    def _by_shard(self, gids):
        gids = np.atleast_1d(np.asarray(gids, np.int64))
        shard = self._route(gids)
        for s in np.unique(shard):
            yield int(s), np.nonzero(shard == s)[0], gids

    def insert(self, ids, rows) -> None:
        rows = np.atleast_2d(np.asarray(rows, np.float32))
        for s, sel, gids in self._by_shard(ids):
            self.shards[s].insert(gids[sel], rows[sel])

    def delete(self, ids) -> None:
        for s, sel, gids in self._by_shard(ids):
            self.shards[s].delete(gids[sel])

    def update(self, ids, rows) -> None:
        rows = np.atleast_2d(np.asarray(rows, np.float32))
        for s, sel, gids in self._by_shard(ids):
            self.shards[s].update(gids[sel], rows[sel])

    def compact(self) -> None:
        for s in self.shards:
            s.compact()

    def search(self, queries, k: int = 10,
               runtime: Optional[RuntimeConfig] = None):
        """Global top-k under churn: the per-shard segment-merged searches,
        one after another, then a k x n_shards host merge (a stable argsort:
        ties break toward the lower shard, as in `sharded_search`).

        Returns (ids (B, k), scores (B, k)) as numpy arrays and
        `ShardedStats`."""
        active = _trace.enabled() or (runtime is not None and runtime.obs)
        # the dispatch span is unfenced: it times the shards' host work and
        # whatever device work their own syncs wait for
        with _trace.span("sharded_dispatch", active=active,
                         metric="sharded.dispatch_us"):
            launched = [shard.search(queries, k=k, runtime=runtime)
                        for shard in self.shards]
        with _trace.span("sharded_merge", active=active,
                         metric="sharded.merge_us") as sp:
            ids_all = [_host(ids) for ids, _, _ in launched]
            scores_all = [_host(scores) for _, scores, _ in launched]
            pages = sum(int(np.sum(_host(st.pages))) for _, _, st in launched)
            cand = sum(int(np.sum(_host(st.candidates)))
                       for _, _, st in launched)
            exhausted = int(np.sum(np.any(
                np.stack([_host(st.exhausted) for _, _, st in launched]),
                axis=0)))
            flat_i = np.concatenate(ids_all, axis=1)
            flat_s = np.concatenate(scores_all, axis=1)
            pos = np.argsort(-flat_s, axis=1, kind="stable")[:, :k]
            stats = ShardedStats(pages=pages, candidates=cand,
                                 exhausted=exhausted,
                                 queries=int(flat_i.shape[0]))
            out = sp.fence((np.take_along_axis(flat_i, pos, axis=1),
                            np.take_along_axis(flat_s, pos, axis=1)))
        return out[0], out[1], stats

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> tuple[dict, dict]:
        """(arrays, meta): per-shard `MutableProMIPS.state_dict` outputs with
        ``shard{i}_`` key prefixes, plus the global-ID routing bounds (the
        JAX package's layout)."""
        arrays: dict = {"bounds": np.asarray(self.bounds, np.int64)}
        shard_metas = []
        for i, shard in enumerate(self.shards):
            a, m = shard.state_dict()
            arrays.update({f"shard{i}_{key}": v for key, v in a.items()})
            shard_metas.append(m)
        return arrays, dict(n_shards=len(self.shards), shards=shard_metas)

    @classmethod
    def from_state(cls, arrays: dict, meta: dict,
                   device="cuda") -> "MutableShardedProMIPS":
        """Inverse of :meth:`state_dict` (also reads the JAX package's), every
        shard on ``device``."""
        from ..stream.mutable import MutableProMIPS

        dev = resolve_device(device)
        obj = cls.__new__(cls)
        obj.bounds = np.asarray(arrays["bounds"], np.int64)
        obj.shards = []
        for i in range(int(meta["n_shards"])):
            prefix = f"shard{i}_"
            shard_arrays = {key[len(prefix):]: v for key, v in arrays.items()
                            if key.startswith(prefix)}
            obj.shards.append(MutableProMIPS.from_state(
                shard_arrays, meta["shards"][i], device=dev))
        return obj


__all__ = ["ShardedIndex", "ShardedStats", "build_sharded",
           "device_put_sharded_index", "sharded_search",
           "MutableShardedProMIPS"]
