"""In-graph fused two-phase search (``verification="fused"`` on the card);
port of `repro.core.search_graph`.

The host driver (`search_fused.search_batch_fused`) pulls each round's
(B, NB) selection to the host, sizes the verification tile there with numpy
and sends the tile back. Here every step stays on the device, in torch ops:
the union count, the best-first truncation under the cap
(`search_device.truncate_union` over `block_priority`), the slot list in
ascending layout order, ``sel`` and ``lost``. The tile size follows the host
driver's rule exactly: the smallest of the pow2 buckets of `_tile_buckets`
(pow2s below the cap, then the cap) that holds the union, i.e.
``min(next_pow2(union), cap)``, or every block in place (the dense tile)
when the union covers at least ``dense_frac`` of the blocks and the cap
allows. An empty round is the identity with zero pages and candidates, as
the host driver's skip.

Each search runs as three stages: the frontend (projection, Quick-Probe,
round-1 masks, the sketch prefilter, round 1's plan); round 1 at its chosen
tile with the Condition-B compensation masks and round 2's plan; round 2
with the stats. The only values that leave the device are the two 8-byte
tile choices read between the stages. On the card each stage variant (the
frontend; round 1 per tile choice; round 2 per tile choice) runs eagerly
the first time it is needed and is captured as a CUDA graph the second
time; from then on it is replayed (`_Graphs`). The graphs of one (index,
batch size, knobs) key share one private memory pool and keep what passes
between round 1 and round 2 in static buffers, so any variant of one stage
can follow any variant of the one before. On the CPU the same stages run
eagerly.

Results (ids, scores, every `SearchStats` field) are bit-identical to
`search_fused.search_batch_fused` at every budget, with and without the
prefilter: the tile holds the same blocks in the same order, plus padding
slots whose ``sel`` column is False, and a dense plain round keeps its
(B, n_pad) score matrix for round 2 as the host driver does.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from ..kernels import build, ops
from .index import IndexArrays, IndexMeta
from .search_common import DENSE_FRAC
from .search_device import (SearchStats, block_priority, compensation_masks,
                            prefilter_round1, prefilter_round2,
                            select_frontend, truncate_union)

EMPTY = -1   # the tile choice of a round with no selected block


def _tile_buckets(cap: int) -> tuple:
    """Static pow2 tile sizes for a ``cap``-block budget: every value
    ``min(next_pow2(u), cap)`` can take for u in [1, n_blocks]."""
    sizes = []
    s = 1
    while s < cap:
        sizes.append(s)
        s <<= 1
    sizes.append(cap)
    return tuple(sizes)


class _Cfg(NamedTuple):
    """The knobs one set of graphs is specialized to."""
    k: int
    cap: int
    cap2: int
    norm_adaptive: bool
    cs_prune: bool
    on_kernels: bool
    prefilter: bool
    prefilter_eps: float
    min_dense: int      # smallest union that takes the dense tile


class _Plan(NamedTuple):
    """One round's tile plan, on the device."""
    order: torch.Tensor    # (NB,) the cap-surviving union blocks first, in
                           # layout order, then the rest
    n_keep: torch.Tensor   # () how many of ``order`` are in the tile
    choice: torch.Tensor   # () bucket index, len(buckets) = dense, EMPTY


class _Front(NamedTuple):
    """What the frontend hands to both rounds."""
    q_l2sq: torch.Tensor
    d_sp: torch.Tensor
    r0: torch.Tensor
    probe_ok: torch.Tensor
    c_half: torch.Tensor
    mask0: torch.Tensor
    prio: Optional[torch.Tensor]
    mask_r1: torch.Tensor
    sk_est: Optional[torch.Tensor]
    sk_bnd: Optional[torch.Tensor]
    sk_bvalid: Optional[torch.Tensor]
    plan: _Plan


class _Mid(NamedTuple):
    """What round 1 and the compensation masks hand to round 2."""
    top_s: torch.Tensor
    top_r: torch.Tensor
    pages1: torch.Tensor
    cand1: torch.Tensor
    lost1: torch.Tensor
    need2: torch.Tensor
    r1: torch.Tensor
    mask_r2: torch.Tensor
    order2: torch.Tensor
    n_keep2: torch.Tensor
    choice2: torch.Tensor
    cache: Optional[torch.Tensor]   # (B, n_pad) scores of a dense plain round


def _plan(mask, prio, cap: int, n_blocks: int, min_dense: int) -> _Plan:
    """The host driver's `_plan_tile` rule on the device, with no sync."""
    union = mask.any(dim=0)                                       # (NB,)
    n_union = union.sum()
    keep = truncate_union(union, prio, cap)
    n_keep = keep.sum()
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    n_pow2 = len(_tile_buckets(cap)) - 1
    pow2 = torch.ones(n_pow2, dtype=torch.int64, device=mask.device) << torch.arange(
        n_pow2, device=mask.device)
    choice = (pow2 < n_union).sum()      # the smallest bucket >= the union
    if cap >= n_blocks:
        choice = choice.masked_fill(n_union >= min_dense, n_pow2 + 1)
    return _Plan(order, n_keep, choice.masked_fill(n_union == 0, EMPTY))


def _tile(mask, order, n_keep, choice: int, cap: int, n_blocks: int):
    """(slots (NS,) i32, sel (B, NS), lost (B,), dense) of a tile choice."""
    sizes = _tile_buckets(cap)
    dev = mask.device
    if choice == len(sizes):
        slots = torch.arange(n_blocks, dtype=torch.int32, device=dev)
        return slots, mask, torch.zeros(mask.shape[0], dtype=torch.bool,
                                        device=dev), True
    n_slots = sizes[choice]
    take = order[:n_slots]
    slot_valid = torch.arange(n_slots, device=dev) < n_keep
    sel = mask[:, take] & slot_valid[None, :]
    in_tile = torch.zeros(n_blocks, dtype=torch.bool, device=dev).scatter_(
        0, take, slot_valid)
    lost = (mask & ~in_tile[None, :]).any(dim=1)
    return take.int(), sel, lost, False


def _frontend(arrays: IndexArrays, meta: IndexMeta, queries,
              cfg: _Cfg) -> _Front:
    """Projection, Quick-Probe, round-1 masks, the prefilter and round 1's
    plan."""
    use_kernels = cfg.on_kernels
    q_proj, q_l2sq, d_sp, r0, probe_ok, c_half, mask0 = select_frontend(
        arrays, meta, queries, use_kernels)
    # the best-first truncation key, only when a finite cap can truncate
    prio = (block_priority(arrays, q_proj)
            if min(cfg.cap, cfg.cap2) < meta.n_blocks else None)
    mask_r1, sk = mask0, (None, None, None)
    if cfg.prefilter:
        mask_r1, *sk = prefilter_round1(arrays, queries, mask0, cfg.k,
                                        meta.page_rows, cfg.prefilter_eps,
                                        use_kernels)
    plan = _plan(mask_r1, prio, cfg.cap, meta.n_blocks, cfg.min_dense)
    return _Front(q_l2sq, d_sp, r0, probe_ok, c_half, mask0, prio, mask_r1,
                  *sk, plan)


def _middle(arrays: IndexArrays, meta: IndexMeta, queries, fr: _Front,
            choice1: int, cfg: _Cfg) -> _Mid:
    """Round 1 at tile ``choice1``, Condition B, the compensation masks and
    round 2's plan."""
    n_batch, dev, k = queries.shape[0], queries.device, cfg.k
    top_s = torch.full((n_batch, k), float("-inf"), device=dev)
    top_r = torch.full((n_batch, k), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros(n_batch, dtype=torch.int32, device=dev)
    false = torch.zeros(n_batch, dtype=torch.bool, device=dev)
    pages1, cand1, done_a, lost1, cache = zero, zero, false, false, None
    if choice1 != EMPTY:
        slots, sel, lost1, dense = _tile(fr.mask_r1, fr.plan.order,
                                         fr.plan.n_keep, choice1, cfg.cap,
                                         meta.n_blocks)
        init_s = top_s
        top_s, top_r, cnt, pages1, cand1 = ops.block_mips(
            arrays.x, arrays.ids >= 0, queries, slots, sel, top_s, top_r,
            fr.c_half, k=k, page_rows=meta.page_rows, dense=dense,
            use_kernels=cfg.on_kernels)
        # "running k-th best >= threshold" <=> "n0 + selected hits >= k"
        n0 = (init_s >= fr.c_half[:, None]).sum(dim=1)
        done_a = (n0 + cnt.sum(dim=1)) >= k
        if dense and not cfg.on_kernels:
            # a dense plain round scored the whole corpus: round 2 reads
            # these scores, as the host driver's cache
            cache = (arrays.x @ queries.T).T
    s_k = top_s[:, k - 1]
    need2, r1, mask1 = compensation_masks(arrays, meta, fr.d_sp, fr.q_l2sq,
                                          s_k, fr.r0, done_a, fr.mask0,
                                          cfg.norm_adaptive, cfg.cs_prune)
    mask_r2 = mask1
    if cfg.prefilter:
        mask_r2 = prefilter_round2(mask1, fr.sk_est, fr.sk_bnd, fr.sk_bvalid,
                                   s_k)
    plan2 = _plan(mask_r2, fr.prio, cfg.cap2, meta.n_blocks, cfg.min_dense)
    return _Mid(top_s, top_r, pages1, cand1, lost1, need2, r1, mask_r2,
                *plan2, cache)


def _finish(arrays: IndexArrays, meta: IndexMeta, queries, fr: _Front,
            mid: _Mid, choice2: int, cached: bool, cfg: _Cfg):
    """Round 2 at tile ``choice2`` (over the cached scores when ``cached``)
    and the results: (ids (B, k), scores (B, k), SearchStats)."""
    n_batch, dev, k = queries.shape[0], queries.device, cfg.k
    top_s, top_r = mid.top_s, mid.top_r
    pages2 = cand2 = torch.zeros(n_batch, dtype=torch.int32, device=dev)
    lost2 = torch.zeros(n_batch, dtype=torch.bool, device=dev)
    valid = arrays.ids >= 0
    if choice2 != EMPTY:
        slots, sel, lost2, dense = _tile(mid.mask_r2, mid.order2, mid.n_keep2,
                                         choice2, cfg.cap2, meta.n_blocks)
        if cached:
            top_s, top_r, _, pages2, cand2 = ops.block_mips_cached(
                mid.cache, valid, slots, sel, top_s, top_r, fr.c_half, k=k,
                page_rows=meta.page_rows)
        else:
            top_s, top_r, _, pages2, cand2 = ops.block_mips(
                arrays.x, valid, queries, slots, sel, top_s, top_r, fr.c_half,
                k=k, page_rows=meta.page_rows, dense=dense,
                use_kernels=cfg.on_kernels)
    stats = SearchStats(
        pages=mid.pages1 + pages2,
        candidates=mid.cand1 + cand2,
        probe_passed=fr.probe_ok,
        used_round2=mid.need2,
        radius0=fr.r0,
        radius1=torch.where(mid.need2, mid.r1, torch.zeros_like(mid.r1)),
        exhausted=mid.lost1 | (mid.need2 & lost2),
        rows=top_r,
    )
    ids = torch.where(top_r >= 0, arrays.ids[torch.clamp(top_r, min=0).long()],
                      torch.full_like(top_r, -1))
    return ids, top_s, stats


def _run_eager(arrays: IndexArrays, meta: IndexMeta, queries, cfg: _Cfg):
    fr = _frontend(arrays, meta, queries, cfg)
    choice1 = int(fr.plan.choice)
    mid = _middle(arrays, meta, queries, fr, choice1, cfg)
    cached = mid.cache is not None
    return _finish(arrays, meta, queries, fr, mid, int(mid.choice2), cached,
                   cfg)


class _Graphs:
    """The CUDA graphs of one (index arrays, batch size, knobs) key.

    Stage variants are keyed ("front",), ("round1", choice1) and ("round2",
    choice2, cached). A variant runs eagerly the first time it is needed
    (which also warms up cuBLAS and the allocator for it) and is captured
    the second time, once the tensors it reads are static: the query
    buffer, the frontend graph's outputs and the `_Mid` buffers that every
    round-1 variant writes. The graphs share one private pool; only
    temporaries live there, apart from the frontend graph's outputs, which
    it keeps for good. Every kernel launched while a graph is captured is
    tallied for it and counted in `build.LAUNCHES` at each replay. One
    search at a time runs through a key (its lock); a search on another
    stream than the last one first waits for it on the device.
    """

    def __init__(self, arrays: IndexArrays, meta: IndexMeta, cfg: _Cfg,
                 n_batch: int):
        dev = arrays.x.device
        self.arrays, self.meta, self.cfg = arrays, meta, cfg
        self.q = torch.empty((n_batch, meta.d), dtype=torch.float32,
                             device=dev)
        self.stream = torch.cuda.Stream(dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        self.last_stream = None
        self.seen = set()
        self.graphs = {}           # variant key -> (CUDAGraph, outputs, tally)
        self.mid: Optional[_Mid] = None

    def _stage(self, key, fn, static_inputs: bool):
        if key in self.graphs:
            graph, out, tally = self.graphs[key]
        elif key in self.seen and static_inputs:
            graph, tally = torch.cuda.CUDAGraph(), {}
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream), build.counting_into(tally):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    out = fn()
                finally:
                    graph.capture_end()
            self.graphs[key] = (graph, out, tally)
        else:
            self.seen.add(key)
            return fn()
        graph.replay()
        build.add_launches(tally)
        return out

    def _to_mid(self, mid: _Mid) -> _Mid:
        """Copy round 1's results into the static `_Mid` buffers (made on
        the variant's eager run, never inside a capture)."""
        if self.mid is None:
            self.mid = _Mid(*(None for _ in _Mid._fields))
        bufs = []
        for have, new in zip(self.mid, mid):
            if have is None and new is not None:
                have = torch.empty_like(new)
            if new is not None:
                have.copy_(new)
            bufs.append(have)
        self.mid = _Mid(*bufs)
        return self.mid

    def run(self, queries):
        arrays, meta, cfg = self.arrays, self.meta, self.cfg
        cur = torch.cuda.current_stream(queries.device)
        with self.lock, torch.cuda.device(queries.device):
            if self.last_stream is not None and self.last_stream != cur:
                cur.wait_stream(self.last_stream)
            self.q.copy_(queries)
            q = self.q
            fr = self._stage(("front",), lambda: _frontend(arrays, meta, q, cfg),
                             True)
            # the later stages may be captured only against the frontend
            # graph's outputs, not an eager run's
            static = ("front",) in self.graphs
            choice1 = int(fr.plan.choice)
            mid = self._stage(
                ("round1", choice1),
                lambda: self._to_mid(_middle(arrays, meta, q, fr, choice1, cfg)),
                static)
            # a dense plain round 1 left its scores for round 2
            cached = (choice1 == len(_tile_buckets(cfg.cap))
                      and not cfg.on_kernels)
            choice2 = int(mid.choice2)
            ids, scores, stats = self._stage(
                ("round2", choice2, cached),
                lambda: _finish(arrays, meta, q, fr, mid, choice2, cached,
                                cfg),
                static)
            out = (ids.clone(), scores.clone(),
                   SearchStats(*(t.clone() for t in stats)))
            self.last_stream = cur
        return out


# graphs per key, least recently used first; an evicted key's graphs and
# pool are released after a device sync (no replay of them is in flight)
_GRAPHS: "OrderedDict[tuple, _Graphs]" = OrderedDict()
_GRAPHS_MAX = 8
_graphs_lock = threading.Lock()


def _graphs_for(arrays: IndexArrays, meta: IndexMeta, cfg: _Cfg,
                n_batch: int) -> _Graphs:
    # the entry keeps ``arrays`` alive, so the tensors' ids stay theirs
    key = (tuple(id(t) for t in arrays), meta, cfg, n_batch)
    with _graphs_lock:
        entry = _GRAPHS.get(key)
        if entry is None:
            entry = _Graphs(arrays, meta, cfg, n_batch)
            _GRAPHS[key] = entry
            if len(_GRAPHS) > _GRAPHS_MAX:
                torch.cuda.synchronize()
                _GRAPHS.popitem(last=False)
        _GRAPHS.move_to_end(key)
        return entry


def clear_graphs() -> None:
    """Release every captured search graph and its memory pool."""
    with _graphs_lock:
        if _GRAPHS:
            torch.cuda.synchronize()
        _GRAPHS.clear()


def search_batch_fused_graph(
    arrays: IndexArrays,
    meta: IndexMeta,
    queries: torch.Tensor,
    k: int = 10,
    budget: int = 64,
    budget2: int = 64,
    norm_adaptive: bool = False,
    cs_prune: bool = False,
    use_kernels: Optional[bool] = None,
    prefilter: bool = False,
    prefilter_eps: float = 1.0,
    dense_frac: float = DENSE_FRAC,
    tile_cap: Optional[int] = None,
):
    """c-k-AMIP search, fused backend, with the tile plan on the device.
    Same contract and bit-identical results as
    `search_fused.search_batch_fused`; on CUDA queries the stages replay as
    CUDA graphs (`_Graphs`), on the CPU they run eagerly. Returns (ids
    (B, k), scores (B, k), SearchStats)."""
    n_blocks = meta.n_blocks
    cap = min(budget, n_blocks)
    cap2 = min(budget2, n_blocks)
    if tile_cap is not None:
        cap = min(cap, int(tile_cap))
        cap2 = min(cap2, int(tile_cap))
    on_kernels = queries.is_cuda if use_kernels is None else bool(use_kernels)
    if on_kernels and not queries.is_cuda:
        raise ValueError("use_kernels=True needs CUDA tensors, got "
                         f"{queries.device}")
    cfg = _Cfg(k=int(k), cap=int(cap), cap2=int(cap2),
               norm_adaptive=bool(norm_adaptive), cs_prune=bool(cs_prune),
               on_kernels=on_kernels, prefilter=bool(prefilter),
               prefilter_eps=float(prefilter_eps),
               min_dense=math.ceil(dense_frac * n_blocks))
    if not queries.is_cuda:
        return _run_eager(arrays, meta, queries, cfg)
    return _graphs_for(arrays, meta, cfg, queries.shape[0]).run(queries)


__all__ = ["search_batch_fused_graph", "clear_graphs", "_tile_buckets"]
