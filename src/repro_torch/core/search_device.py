"""Batched block selection of the two-phase search (MIP-Search-II,
Algorithm 3, at block granularity); port of the parts of
`repro.core.search_device` that the fused driver runs.

  quick-probe -> radius r -> sub-partition sphere filter -> block masks
  -> (verification, in `search_fused`) -> Condition B -> compensation
  masks over the blocks not scanned in round 1.

Everything is batch-native: one (B, NB) mask per round for the whole batch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops
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


def select_frontend(arrays: IndexArrays, meta: IndexMeta, queries):
    """Phase 1 for a (B, d) batch: projection, batched Quick-Probe,
    Condition-A thresholds and the round-1 block selection.

    Returns (q_proj (B, m), q_l2sq (B,), d_sp (B, S), r0 (B,), probe_ok (B,),
    c_half (B,), mask0 (B, NB))."""
    q_proj = queries @ arrays.a
    q_l1 = queries.abs().sum(dim=1)
    q_l2sq = (queries * queries).sum(dim=1)
    _, r0, probe_ok = quick_probe_batch(_group_table(arrays), q_proj, q_l1,
                                        meta.c, meta.x_p)
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
