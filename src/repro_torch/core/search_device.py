"""Batched block selection of the two-phase search (MIP-Search-II,
Algorithm 3, at block granularity) and the batched verification backend;
port of `repro.core.search_device` without its scan and progressive
drivers.

  quick-probe -> radius r -> sub-partition sphere filter -> block masks
  -> verification -> Condition B -> compensation masks over the blocks not
  scanned in round 1 -> verification.

Everything is batch-native: one (B, NB) mask per round for the whole batch.
Verification is the fused driver (`search_fused`) or, here,
``verification="batched"``: per round the blocks selected by any query are
unioned, their rows gathered into one (R, d) tile and every query scored
against it in one `ops.mips_score` call; the sequential Condition-A stop is
then rebuilt exactly from the scores (`_verify_batched`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import ops, ref
from . import search_common as sc
from .index import IndexArrays, IndexMeta
from .quick_probe import GroupTable, quick_probe_batch


class SearchStats(NamedTuple):
    pages: torch.Tensor          # logical data-page accesses per query
    candidates: torch.Tensor     # verified candidate rows per query
    probe_passed: torch.Tensor   # Quick-Probe Test A hit (bool)
    used_round2: torch.Tensor    # compensation round triggered (bool)
    radius0: torch.Tensor        # Quick-Probe radius
    radius1: torch.Tensor        # compensation radius (0 if unused)
    exhausted: torch.Tensor      # budget ran out before Condition B held
    rows: torch.Tensor           # top-k rows in the padded sorted layout (-1 = empty)


class TopK(NamedTuple):
    scores: torch.Tensor  # (B, k) descending inner products
    rows: torch.Tensor    # (B, k) rows in the sorted layout (-1 = empty)


def _group_table(arrays: IndexArrays) -> GroupTable:
    return GroupTable(code=arrays.g_code, min_l1=arrays.g_min_l1,
                      rep_proj=arrays.g_rep_proj, rep_row=arrays.g_rep_row,
                      count=arrays.g_count)


def subpart_distances(arrays: IndexArrays, q_proj):
    """(B, S) projected-query to sub-partition-center distances, via
    ||c - q||^2 = ||c||^2 - 2 <c, q> + ||q||^2 clamped at 0. Computed once
    per search and reused by both rounds."""
    center = arrays.sp_center                                   # (S, m)
    d2 = ((center * center).sum(dim=-1)[None, :]
          - 2.0 * (q_proj @ center.T)
          + (q_proj * q_proj).sum(dim=-1)[:, None])             # (B, S)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def blocks_from_radii(arrays: IndexArrays, d_sp, radius):
    """Sphere-overlap filter from sub-partitions to blocks: (B, NB) bool.

    ``radius`` is (B,) or (B, S); entries < 0 deselect. A block is selected
    iff any of its sub-partitions (``block_sp_idx``) is."""
    if radius.dim() == 1:
        radius = radius[:, None]
    sel_sp = sc.sphere_select(d_sp, arrays.sp_radius[None, :], radius)  # (B, S)
    idx = arrays.block_sp_idx
    gathered = sel_sp[:, torch.clamp(idx, min=0).long()]        # (B, NB, KMAX)
    return (gathered & (idx >= 0)[None]).any(dim=2)


def block_priority(arrays: IndexArrays, q_proj):
    """Best-first key for budget truncation (ascending = more promising):
    per block, minus the largest Cauchy-Schwarz upper bound
    ``q_proj . center + |q_proj| * radius`` of any batch query over the
    block's sub-partitions, clamped finite."""
    q_norm = torch.sqrt((q_proj * q_proj).sum(dim=1))           # (B,)
    ub = (q_proj @ arrays.sp_center.T
          + q_norm[:, None] * arrays.sp_radius[None, :])        # (B, S)
    ub = ub.amax(dim=0)                                         # (S,)
    idx = arrays.block_sp_idx
    gathered = torch.where(idx >= 0, ub[torch.clamp(idx, min=0).long()],
                           torch.full(idx.shape, float("-inf"), device=ub.device))
    return torch.clamp(-gathered.amax(dim=1), max=1e30)


def select_frontend(arrays: IndexArrays, meta: IndexMeta, queries,
                    use_kernels: Optional[bool] = None):
    """Phase 1 for a (B, d) batch: projection, batched Quick-Probe (its
    group bounds through `ops.binary_probe_lb`), Condition-A thresholds and
    the round-1 block selection.

    Returns (q_proj (B, m), q_l2sq (B,), d_sp (B, S), r0 (B,), probe_ok (B,),
    c_half (B,), mask0 (B, NB))."""
    q_proj = queries @ arrays.a
    q_l1 = queries.abs().sum(dim=1)
    q_l2sq = (queries * queries).sum(dim=1)
    _, r0, probe_ok = quick_probe_batch(_group_table(arrays), q_proj, q_l1,
                                        meta.c, meta.x_p, use_kernels)
    c_half = sc.condition_a_threshold(arrays.max_l2sq, q_l2sq, meta.c)
    d_sp = subpart_distances(arrays, q_proj)
    mask0 = blocks_from_radii(arrays, d_sp, r0)
    return q_proj, q_l2sq, d_sp, r0, probe_ok, c_half, mask0


def compensation_masks(arrays: IndexArrays, meta: IndexMeta, d_sp, q_l2sq,
                       s_k, r0, done_a, mask0, norm_adaptive: bool,
                       cs_prune: bool):
    """Condition-B test + compensation-round selection (Algorithm 3 line 12).
    Returns (need2 (B,), r1 (B,), mask1 (B, NB)), ``mask1`` restricted to
    blocks not scanned in round 1."""
    cond_b = sc.condition_b(r0 * r0, s_k, arrays.max_l2sq, q_l2sq, meta.c,
                            meta.x_p)
    r1 = sc.compensation_radius(s_k, arrays.max_l2sq, q_l2sq, meta.c, meta.x_p)
    need2 = ~(cond_b | done_a)
    if norm_adaptive:
        r_comp = sc.adaptive_radii(arrays.sp_max_l2sq[None, :], s_k[:, None],
                                   q_l2sq[:, None], meta.c, meta.x_p,
                                   cs_prune=cs_prune)           # (B, S)
        r_comp = torch.where(need2[:, None], r_comp, torch.full_like(r_comp, -1.0))
    else:
        r_comp = torch.where(need2, r1, torch.full_like(r1, -1.0))[:, None]
    mask1 = blocks_from_radii(arrays, d_sp, r_comp) & ~mask0
    return need2, r1, mask1


def prefilter_round1(arrays: IndexArrays, queries, mask0, k: int,
                     page_rows: int, eps: float, use_kernels=None):
    """Sketch prefilter, round 1: score the block sketch for every block
    before any page is read and keep the blocks whose upper bound clears
    tau. Returns (surv (B, NB), est, bnd, bvalid); the last three are reused
    by `prefilter_round2`."""
    est = ops.sketch_scores(queries, arrays.sk_mu, arrays.sk_codebooks,
                            arrays.sk_codes, use_kernels=use_kernels)
    bnd = sc.sketch_margin(queries, arrays.sk_err, eps)
    bvalid = sc.block_valid_from_ids(arrays.ids, page_rows)
    surv = sc.sketch_survivors_round1(mask0, est, bnd, bvalid, k)
    return surv, est, bnd, bvalid


def prefilter_round2(mask1, est, bnd, bvalid, s_k):
    """Compensation-round sketch pruning against the realized k-th score."""
    return sc.sketch_survivors_round2(mask1, est, bnd, bvalid, s_k)


def truncate_union(union, prio, cap: int):
    """Blocks surviving a ``cap``-slot verification tile: the union as it is
    when ``prio`` is None (full budget), else the ``cap`` best union blocks
    by ``prio`` (ascending, ties to the lower block by a stable sort)."""
    if prio is None:
        return union
    key = torch.where(union, prio, torch.full_like(prio, float("inf")))
    best = torch.sort(key, stable=True).indices[:cap]
    keep = torch.zeros_like(union)
    keep[best] = True
    return keep & union


def _verify_batched(arrays: IndexArrays, meta: IndexMeta, queries,
                    block_masks, tops: TopK, c_half, k: int, budget: int,
                    use_kernels, prio=None):
    """One verification round for the whole batch over the union tile.

    block_masks (B, NB) selected blocks; tops the carried top-k; c_half (B,)
    Condition-A thresholds. Returns (tops', pages (B,), candidates (B,),
    done_a (B,), lost (B,)): the sequential scan's stop block, page and
    candidate counts and top-k, rebuilt from one score tile; ``lost`` flags
    queries whose selection did not fit the ``budget``-block tile. The tile
    keeps the union's blocks in layout order (`truncate_union` picks which
    survive a truncating budget)."""
    n_batch = queries.shape[0]
    page_rows = meta.page_rows
    n_blocks = arrays.block_sp_lo.shape[0]
    budget = min(budget, n_blocks)
    dev = queries.device

    union = block_masks.any(dim=0)                                # (NB,)
    keep = truncate_union(union, prio, budget)
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices  # kept first
    slots = order[:budget]                                        # (budget,)
    slot_valid = torch.arange(budget, device=dev) < keep.sum()
    in_tile = torch.zeros(n_blocks, dtype=torch.bool, device=dev)
    in_tile[slots] = slot_valid

    rows = (slots[:, None] * page_rows
            + torch.arange(page_rows, device=dev)[None, :]).reshape(-1)
    x_tile = arrays.x[rows]                                       # (R, d)
    row_valid = (arrays.ids[rows] >= 0) & slot_valid.repeat_interleave(page_rows)
    scores = ops.mips_score(x_tile, queries, row_valid,
                            use_kernels=use_kernels).T            # (B, R)

    # the running k-th best reaches c_half after block t iff at least k rows
    # (the carried top-k included) score >= c_half in blocks <= t
    sel_slots = block_masks[:, slots] & slot_valid[None, :]       # (B, budget)
    row_sel = sel_slots.repeat_interleave(page_rows, dim=1)       # (B, R)
    ge = (scores >= c_half[:, None]) & row_sel & row_valid[None, :]
    cnt = ge.view(n_batch, budget, page_rows).sum(dim=2)          # (B, budget)
    n0 = (tops.scores >= c_half[:, None]).sum(dim=1)              # carried hits
    ex_cum = torch.cumsum(cnt, dim=1) - cnt                       # exclusive
    live = sel_slots & ((n0[:, None] + ex_cum) < k)
    pages = live.sum(dim=1, dtype=torch.int32)

    row_live = live.repeat_interleave(page_rows, dim=1) & row_valid[None, :]
    cand = row_live.sum(dim=1, dtype=torch.int32)
    done_a = (n0 + torch.where(live, cnt, torch.zeros_like(cnt)).sum(dim=1)) >= k

    masked = torch.where(row_live, scores, torch.full_like(scores, float("-inf")))
    row_ids = torch.where(row_live, rows.to(torch.int32)[None, :],
                          torch.full_like(row_live, -1, dtype=torch.int32))
    merged_s = torch.cat([tops.scores, masked], dim=1)
    merged_r = torch.cat([tops.rows, row_ids], dim=1)
    best_s, idx = ref.topk_stable(merged_s, k)
    best_r = merged_r.gather(1, idx)

    lost = (block_masks & ~in_tile[None, :]).any(dim=1)
    return TopK(scores=best_s, rows=best_r), pages, cand, done_a, lost


def _search_batch_batched(arrays: IndexArrays, meta: IndexMeta, queries, k: int,
                         budget: int, budget2: int, norm_adaptive: bool,
                         cs_prune: bool, use_kernels=None, prefilter=False,
                         prefilter_eps=1.0):
    """Two-phase search with batched verification: the frontend, one
    `_verify_batched` round, Condition B and the compensation masks, and a
    second round only when some query needs it (a host check, where the JAX
    package has a `lax.cond`). Returns (ids (B, k), scores (B, k),
    SearchStats)."""
    n_batch = queries.shape[0]
    n_blocks = arrays.block_sp_lo.shape[0]
    dev = queries.device
    q_proj, q_l2sq, d_sp, r0, probe_ok, c_half, mask0 = select_frontend(
        arrays, meta, queries, use_kernels)
    # best-first truncation key, only when a finite budget can truncate
    prio = (block_priority(arrays, q_proj)
            if min(budget, budget2) < n_blocks else None)
    mask_r1 = mask0
    sk_est = sk_bnd = sk_bvalid = None
    if prefilter:
        mask_r1, sk_est, sk_bnd, sk_bvalid = prefilter_round1(
            arrays, queries, mask0, k, meta.page_rows, prefilter_eps,
            use_kernels)
    empty = TopK(scores=torch.full((n_batch, k), float("-inf"), device=dev),
                 rows=torch.full((n_batch, k), -1, dtype=torch.int32,
                                 device=dev))
    top, pages1, cand1, done_a, lost1 = _verify_batched(
        arrays, meta, queries, mask_r1, empty, c_half, k, budget, use_kernels,
        prio=prio)

    s_k = top.scores[:, k - 1]
    need2, r1, mask1 = compensation_masks(arrays, meta, d_sp, q_l2sq, s_k,
                                          r0, done_a, mask0, norm_adaptive,
                                          cs_prune)
    mask_r2 = mask1
    if prefilter:
        mask_r2 = prefilter_round2(mask1, sk_est, sk_bnd, sk_bvalid, s_k)
    if bool(need2.any()):
        top, pages2, cand2, _, lost2 = _verify_batched(
            arrays, meta, queries, mask_r2, top, c_half, k, budget2,
            use_kernels, prio=prio)
    else:   # every query stopped by A or B: the round is an identity
        pages2 = cand2 = torch.zeros(n_batch, dtype=torch.int32, device=dev)
        lost2 = torch.zeros(n_batch, dtype=torch.bool, device=dev)

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
    ids = torch.where(top.rows >= 0,
                      arrays.ids[torch.clamp(top.rows, min=0).long()],
                      torch.full_like(top.rows, -1))
    return ids, top.scores, stats
