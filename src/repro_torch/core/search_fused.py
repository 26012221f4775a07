"""Host-orchestrated fused two-phase search (``verification="fused"``);
port of `repro.core.search_fused`.

Per query batch:
  1. `select_frontend` -> per-query round-1 masks (B, NB);
  2. optionally the sketch prefilter (`prefilter_round1`);
  3. the union of selected blocks is pulled to the host and the tile is
     sized to next_pow2(union) slots (`_plan_tile`), or every block in place
     when the union is dense;
  4. `ops.block_mips` verifies the tile (the CUDA kernel on the card, the
     plain version on the CPU);
  5. `compensation_masks` -> Condition B + round-2 masks, pruned again by
     the sketch; an empty round is skipped on the host;
  6. the second verification round.

With ``obs`` each phase is a span (`obs.trace`) under the JAX driver's
name, fenced when the tracer fences, and the round shapes feed the
``fused.*`` counters.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels import ops
from ..obs import metrics as _metrics
from ..obs.trace import span as _span
from .index import IndexArrays, IndexMeta
from .search_common import DENSE_FRAC, next_pow2
from .search_device import (SearchStats, TopK, block_priority,
                            compensation_masks, prefilter_round1,
                            prefilter_round2, select_frontend)


def _verify(arrays: IndexArrays, valid, queries, slots, sel, top: TopK,
            c_half, k: int, page_rows: int, dense: bool, use_kernels,
            want_scores: bool = False):
    """One fused verification round: (TopK, pages, cand, done_a, cache).
    ``want_scores`` (dense plain rounds only) also returns the (B, n_pad)
    score matrix for a later `_verify_cached` round."""
    top_s, top_r, cnt, pages, cand = ops.block_mips(
        arrays.x, valid, queries, slots, sel, top.scores, top.rows, c_half,
        k=k, page_rows=page_rows, dense=dense, use_kernels=use_kernels)
    # "running k-th best >= threshold" <=> "n0 + selected hits >= k"
    n0 = (top.scores >= c_half[:, None]).sum(dim=1)
    done_a = (n0 + cnt.sum(dim=1)) >= k
    cache = (arrays.x @ queries.T).T if want_scores else None
    return TopK(scores=top_s, rows=top_r), pages, cand, done_a, cache


def _verify_cached(valid, scores_full, slots, sel, top: TopK, c_half, k: int,
                   page_rows: int):
    """Compensation round over a dense previous round's cached scores."""
    top_s, top_r, cnt, pages, cand = ops.block_mips_cached(
        scores_full, valid, slots, sel, top.scores, top.rows, c_half,
        k=k, page_rows=page_rows)
    return TopK(scores=top_s, rows=top_r), pages, cand


def _plan_tile(mask: np.ndarray, cap: int, n_blocks: int,
               dense_frac: float = DENSE_FRAC, prio=None):
    """Size one verification tile from the host-side (B, NB) selection.

    Returns (slots (NS,) i32, sel (B, NS) bool, lost (B,) bool, dense), or
    None when no block is selected (the round is skipped). NS =
    min(next_pow2(union), cap); a union of at least ``dense_frac`` of all
    blocks takes every block in place when the cap allows. ``lost`` flags
    queries whose selection exceeds the ``cap``-block tile; ``prio`` (NB,),
    when given, keeps the best union blocks under a truncating cap (ties by
    layout index), laid out in ascending order.
    """
    union = mask.any(axis=0)
    n_union = int(union.sum())
    if n_union == 0:
        return None
    n_batch = mask.shape[0]
    if n_union >= dense_frac * n_blocks and cap >= n_blocks:
        slots = np.arange(n_blocks, dtype=np.int32)
        return slots, mask, np.zeros(n_batch, bool), True
    n_slots = min(next_pow2(n_union), cap)
    ublocks = np.nonzero(union)[0]                  # ascending layout order
    if n_union > n_slots:
        if prio is not None:                        # best blocks survive,
            best = np.argsort(prio[ublocks], kind="stable")[:n_slots]
            take = np.sort(ublocks[best])           # ...laid out in order
        else:
            take = ublocks[:n_slots]
        in_tile = np.zeros(n_blocks, bool)
        in_tile[take] = True
        lost = (mask & ~in_tile[None, :]).any(axis=1)
    else:
        take = ublocks
        lost = np.zeros(n_batch, bool)
    slots = np.zeros(n_slots, np.int32)
    slots[: len(take)] = take
    sel = np.zeros((n_batch, n_slots), bool)
    sel[:, : len(take)] = mask[:, take]
    return slots, sel, lost, False


def search_batch_fused(
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
    obs: bool = False,
    dense_frac: float = DENSE_FRAC,
    tile_cap: Optional[int] = None,
):
    """c-k-AMIP search, fused backend, for queries (B, d) on the index's
    device. Returns (ids (B, k), scores (B, k), SearchStats).

    ``prefilter`` prunes both rounds' selections with the block sketch
    before any page is read. ``dense_frac`` moves the dense-tile threshold
    (results are identical at any value); ``tile_cap`` clamps both rounds'
    tiles below the budget, truncating under the best-first rule and
    flagging the affected queries ``exhausted``. ``obs`` records the
    per-phase spans and the round-shape counters (the results do not
    change).
    """
    dev = queries.device
    n_blocks = meta.n_blocks
    n_batch = queries.shape[0]
    cap = min(budget, n_blocks)
    cap2 = min(budget2, n_blocks)
    if tile_cap is not None:
        cap = min(cap, int(tile_cap))
        cap2 = min(cap2, int(tile_cap))
    on_kernels = queries.is_cuda if use_kernels is None else bool(use_kernels)
    valid = arrays.ids >= 0

    with _span("select_frontend", active=obs,
               metric="search.frontend_us") as sp:
        q_proj, q_l2sq, d_sp, r0, probe_ok, c_half, mask0 = select_frontend(
            arrays, meta, queries, use_kernels)
        sp.fence(mask0)
    prio_np = (block_priority(arrays, q_proj).cpu().numpy()
               if min(cap, cap2) < n_blocks else None)
    mask_r1 = mask0
    sk_est = sk_bnd = sk_bvalid = None
    if prefilter:
        with _span("prefilter_round1", active=obs,
                   metric="search.prefilter_us") as sp:
            mask_r1, sk_est, sk_bnd, sk_bvalid = prefilter_round1(
                arrays, queries, mask0, k, meta.page_rows, prefilter_eps,
                use_kernels)
            sp.fence(mask_r1)
    zero = torch.zeros(n_batch, dtype=torch.int32, device=dev)
    false = torch.zeros(n_batch, dtype=torch.bool, device=dev)
    top = TopK(scores=torch.full((n_batch, k), float("-inf"), device=dev),
               rows=torch.full((n_batch, k), -1, dtype=torch.int32, device=dev))

    def tile(slots, sel):
        return (torch.from_numpy(slots).to(dev),
                torch.from_numpy(np.ascontiguousarray(sel)).to(dev))

    scores_cache = None
    with _span("plan_tile_round1", active=obs, metric="search.plan_us"):
        mask_np = mask_r1.cpu().numpy()
        if obs and prefilter:
            n_sel = float(mask0.sum())
            _metrics.gauge("search.prefilter_survivor_frac").set(
                float(mask_np.sum()) / max(n_sel, 1.0))
        plan = _plan_tile(mask_np, cap, n_blocks, dense_frac, prio=prio_np)
    if plan is None:
        if obs:
            _metrics.counter("fused.rounds_skipped").inc()
        pages1, cand1, done_a, lost1 = zero, zero, false, false
    else:
        slots, sel, lost_np, dense = plan
        if obs:
            _metrics.counter("fused.rounds_dense" if dense
                             else "fused.rounds_sparse").inc()
        # a dense plain round scores the whole corpus in place; keep that
        # (B, n_pad) product so the compensation round needs no new matmul
        want_scores = dense and not on_kernels
        with _span("verify_round1", active=obs,
                   metric="search.verify_round_us") as sp:
            top, pages1, cand1, done_a, scores_cache = _verify(
                arrays, valid, queries, *tile(slots, sel), top, c_half, k,
                meta.page_rows, dense, use_kernels, want_scores)
            sp.fence(top.scores)
        lost1 = torch.from_numpy(lost_np).to(dev)

    with _span("compensation", active=obs,
               metric="search.compensation_us") as sp:
        s_k = top.scores[:, k - 1]
        need2, r1, mask1 = compensation_masks(arrays, meta, d_sp, q_l2sq, s_k,
                                              r0, done_a, mask0, norm_adaptive,
                                              cs_prune)
        sp.fence(mask1)
    mask_r2 = mask1
    if prefilter:
        with _span("prefilter_round2", active=obs,
                   metric="search.prefilter_us") as sp:
            mask_r2 = prefilter_round2(mask1, sk_est, sk_bnd, sk_bvalid, s_k)
            sp.fence(mask_r2)

    with _span("plan_tile_round2", active=obs, metric="search.plan_us"):
        plan = _plan_tile(mask_r2.cpu().numpy(), cap2, n_blocks, dense_frac,
                          prio=prio_np)
    if plan is None:
        if obs:
            _metrics.counter("fused.rounds_skipped").inc()
        pages2, cand2, lost2 = zero, zero, false
    else:
        slots, sel, lost_np, dense = plan
        with _span("verify_round2", active=obs,
                   metric="search.verify_round_us") as sp:
            if scores_cache is not None:
                if obs:
                    _metrics.counter("fused.rounds_cached").inc()
                top, pages2, cand2 = _verify_cached(
                    valid, scores_cache, *tile(slots, sel), top, c_half, k,
                    meta.page_rows)
            else:
                if obs:
                    _metrics.counter("fused.rounds_dense" if dense
                                     else "fused.rounds_sparse").inc()
                top, pages2, cand2, _, _ = _verify(
                    arrays, valid, queries, *tile(slots, sel), top, c_half, k,
                    meta.page_rows, dense, use_kernels)
            sp.fence(top.scores)
        lost2 = torch.from_numpy(lost_np).to(dev)

    stats = SearchStats(
        pages=pages1 + pages2,
        candidates=cand1 + cand2,
        probe_passed=probe_ok,
        used_round2=need2,
        radius0=r0,
        radius1=torch.where(need2, r1, torch.zeros_like(r1)),
        exhausted=lost1 | (need2 & lost2),
        rows=top.rows,
    )
    ids = torch.where(top.rows >= 0, arrays.ids[torch.clamp(top.rows, min=0).long()],
                      torch.full_like(top.rows, -1))
    return ids, top.scores, stats


__all__ = ["search_batch_fused", "DENSE_FRAC"]
