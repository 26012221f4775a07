"""ProMIPS search math on torch tensors; port of the parts of
`repro.core.search_common` the fused two-phase search runs.

Paper mapping (arXiv:2104.04406):
  condition_a_threshold   Theorem 1 (deterministic stop)
  condition_b             Theorem 2, Formula 2/3
  compensation_radius     Algorithm 3 line 12 (range r')
  adaptive_radii          per-sub-partition radii (Theorem 2 with the LOCAL
                          max norm)
  sphere_select           sub-partition sphere-overlap filter
  sketch_*                the quantized-sketch block prefilter
  topk_merge              running c-k-AMIP top-k merge
"""
from __future__ import annotations

import torch

# Scores below this count as "no candidate yet" when clamping the
# Condition-B denominator.
MIN_SCORE = -1e30

# Default dense-path threshold of the fused driver: unions covering at least
# this fraction of all blocks verify every block in place.
DENSE_FRAC = 0.9


def next_pow2(t: int) -> int:
    """Smallest power of two >= t (1 for t <= 1): the tile-size bucketing."""
    return 1 << max(0, int(t) - 1).bit_length()


def condition_a_threshold(max_l2sq, q_l2sq, c: float):
    """Condition A as a threshold on the inner product:
    <o,q> >= c/2 (||o_M||^2 + ||q||^2)."""
    return 0.5 * c * (max_l2sq + q_l2sq)


def condition_b_denominator(best_ip, max_l2sq, q_l2sq, c: float):
    """||o_M||^2 + ||q||^2 - 2<o_max,q>/c, with ``best_ip`` clamped to
    ``MIN_SCORE`` so an empty top-k (-inf) gives a huge finite value."""
    return max_l2sq + q_l2sq - 2.0 * torch.clamp(best_ip, min=MIN_SCORE) / c


def condition_b(proj_dist_sq, best_ip, max_l2sq, q_l2sq, c: float, x_p):
    """Theorem 2 test via the static threshold x_p = Psi_m^{-1}(p); a
    non-positive denominator is Condition A."""
    denom = condition_b_denominator(best_ip, max_l2sq, q_l2sq, c)
    return (denom <= 0.0) | (proj_dist_sq >= x_p * denom)


def compensation_radius(best_ip, max_l2sq, q_l2sq, c: float, x_p):
    """r' = sqrt(x_p * denominator), 0 where the denominator is <= 0."""
    denom = condition_b_denominator(best_ip, max_l2sq, q_l2sq, c)
    return torch.sqrt(torch.clamp(x_p * denom, min=0.0))


def adaptive_radii(local_max_l2sq, best_ip, q_l2sq, c: float, x_p,
                   cs_prune: bool = False):
    """Norm-adaptive Condition-B radii with the regions' own max norms; with
    ``cs_prune``, regions where even Cauchy-Schwarz's best case cannot beat
    the running k-th score get radius -1 (deselected)."""
    denom = condition_b_denominator(best_ip, local_max_l2sq, q_l2sq, c)
    r = torch.sqrt(torch.clamp(x_p * denom, min=0.0))
    if cs_prune:
        ok = torch.sqrt(local_max_l2sq) * torch.sqrt(q_l2sq) >= best_ip
        r = torch.where(ok, r, torch.full_like(r, -1.0))
    return r


def sphere_select(center_dist, region_radius, radius):
    """Does the search ball of ``radius`` meet a region at ``center_dist``
    with ``region_radius``? Radius < 0 deselects outright."""
    return (center_dist <= radius + region_radius) & (radius >= 0.0)


def block_valid_from_ids(ids, page_rows: int):
    """(NB,) bool: does block b hold at least one real (non-padding) row?"""
    return (ids.view(-1, page_rows) >= 0).any(dim=1)


def sketch_margin(queries, sk_err, eps: float):
    """(B, NB) sketch error band eps * ||q|| * err_b."""
    q_norm = torch.sqrt((queries * queries).sum(dim=1))
    return eps * q_norm[:, None] * sk_err[None, :]


def sketch_survivors_round1(mask, est, bnd, bvalid, k: int):
    """Round-1 survivors: candidate blocks whose upper bound est + bnd clears
    tau, the k-th largest of G = min(2k, NB) strided group maxima of the
    lower bound est - bnd (a lower bound on the k-th largest lower bound, so
    the cut is lossless at eps = 1). With NB < k nothing is pruned."""
    nb = est.shape[1]
    g = min(2 * k, nb)
    cand = mask & bvalid[None, :]
    if g < k:
        return cand
    lb = torch.where(cand, est - bnd, torch.full_like(est, float("-inf")))
    pad = (-nb) % g
    if pad:
        fill = torch.full((lb.shape[0], pad), float("-inf"), dtype=lb.dtype,
                          device=lb.device)
        lb = torch.cat([lb, fill], dim=1)
    gm = lb.view(lb.shape[0], -1, g).amax(dim=1)
    tau = torch.sort(gm, dim=1).values[:, g - k]
    return cand & (est + bnd >= tau[:, None])


def sketch_survivors_round2(mask, est, bnd, bvalid, s_k):
    """Compensation-round survivors: blocks whose upper bound reaches the
    realized k-th score s_k (queries with an empty top-k keep everything)."""
    return mask & bvalid[None, :] & (est + bnd >= s_k[:, None])


def topk_merge(top_scores, top_rows, scores, rows, k: int):
    """Merge (scores, rows) into running (B, k) tops along dim 1; ties go to
    the earlier entry (carried first, then new rows in order)."""
    s = torch.cat([top_scores, scores], dim=1)
    r = torch.cat([top_rows, rows], dim=1)
    s_sorted, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return s_sorted[:, :k], r.gather(1, idx[:, :k])
