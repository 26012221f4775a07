"""iDistance with the paper's partition pattern (Section VI, Algorithm 4);
numpy copy of `repro.core.idistance` — the same seed gives the same layout,
bit for bit.

  1. k-means the projected points into k_p partitions (pivots O_i, radii r_i);
  2. ring keys  I(p) = i*C + floor(dis(p, O_i) / eps)   (Formula 6);
  3. k-means each (partition, ring) bucket into k_sp sub-partitions, each
     carrying a pivot + radius for sphere-intersection filtering;
  4. lay points out contiguously per sub-partition, so fixed blocks of
     ``page_rows`` rows play the role of 4 KB disk pages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _pairwise_d2(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    """(n, k) squared distances via the expanded form (no (n,k,d) temps)."""
    xx = (x * x).sum(1)[:, None]
    cc = (c * c).sum(1)[None, :]
    return np.maximum(xx + cc - 2.0 * (x @ c.T), 0.0)


def kmeans_np(x: np.ndarray, k: int, iters: int = 25, seed: int = 0):
    """Lloyd's k-means. k-means++ seeding for small k, random distinct
    seeding for large k (build-time speed). Returns (centers, assign)."""
    n = x.shape[0]
    rng = np.random.RandomState(seed)
    k = max(1, min(k, n))
    x = np.asarray(x, np.float32)
    if k <= 32:
        centers = [x[rng.randint(n)]]
        for _ in range(1, k):
            d2 = _pairwise_d2(x, np.asarray(centers, np.float32)).min(1)
            tot = d2.sum()
            if tot <= 0:
                centers.append(x[rng.randint(n)])
                continue
            centers.append(x[np.searchsorted(np.cumsum(d2 / tot), rng.rand())])
        centers = np.asarray(centers, np.float32)
    else:
        centers = x[rng.choice(n, size=k, replace=False)].copy()
    assign = np.zeros(n, np.int64)
    for it in range(iters):
        new_assign = _pairwise_d2(x, centers).argmin(1)
        if np.array_equal(new_assign, assign) and it > 0:
            break
        assign = new_assign
        counts = np.bincount(assign, minlength=k).astype(np.float32)
        sums = np.zeros_like(centers)
        np.add.at(sums, assign, x)
        nonzero = counts > 0
        centers[nonzero] = sums[nonzero] / counts[nonzero, None]
    return centers, assign


@dataclass(frozen=True)
class IDistanceLayout:
    """Host-side build product (everything in the *sorted* order)."""

    perm: np.ndarray          # (n,) permutation: sorted_row -> original row
    part_center: np.ndarray   # (k_p, m) first-stage pivots O_i
    part_radius: np.ndarray   # (k_p,)   first-stage radii
    eps: float                # ring width (Formula 6)
    c_key: int                # the constant C in Formula 6
    keys: np.ndarray          # (n,) iDistance keys, sorted ascending
    sp_center: np.ndarray     # (S, m) sub-partition pivots
    sp_radius: np.ndarray     # (S,)   sub-partition radii
    sp_start: np.ndarray      # (S+1,) row offsets (contiguous segments)
    sp_key: np.ndarray        # (S,)   iDistance key of each sub-partition
    sp_part: np.ndarray       # (S,)   first-stage partition of each sub-partition


def build_idistance(
    p_pts: np.ndarray,
    k_p: int = 5,
    n_key: int = 40,
    k_sp: int = 10,
    seed: int = 0,
) -> IDistanceLayout:
    """Algorithm 4 (steps 2-6): two-stage partitioning of projected points."""
    n, m = p_pts.shape
    part_center, assign = kmeans_np(p_pts, k_p, seed=seed)
    k_p = part_center.shape[0]
    dist = np.linalg.norm(p_pts - part_center[assign], axis=1)
    part_radius = np.zeros(k_p, np.float32)
    for i in range(k_p):
        mask = assign == i
        part_radius[i] = dist[mask].max() if mask.any() else 0.0
    r_avg = float(part_radius[part_radius > 0].mean()) if (part_radius > 0).any() else 1.0
    eps = max(r_avg / n_key, 1e-6)
    ring = np.floor(dist / eps).astype(np.int64)
    c_key = int(ring.max()) + 2
    keys = assign * c_key + ring  # Formula 6

    perm_parts: list[np.ndarray] = []
    sp_center, sp_radius, sp_key, sp_part, sp_sizes = [], [], [], [], []
    for i in range(k_p):
        for rk in np.unique(ring[assign == i]):
            rows = np.nonzero((assign == i) & (ring == rk))[0]
            centers, sub = kmeans_np(p_pts[rows], min(k_sp, len(rows)), seed=seed + 1)
            for j in range(centers.shape[0]):
                member = rows[sub == j]
                if len(member) == 0:
                    continue
                d = np.linalg.norm(p_pts[member] - centers[j], axis=1)
                perm_parts.append(member)
                sp_center.append(centers[j])
                sp_radius.append(d.max())
                sp_key.append(i * c_key + rk)
                sp_part.append(i)
                sp_sizes.append(len(member))

    perm = np.concatenate(perm_parts).astype(np.int64)
    sp_start = np.concatenate([[0], np.cumsum(sp_sizes)]).astype(np.int64)
    return IDistanceLayout(
        perm=perm,
        part_center=part_center.astype(np.float32),
        part_radius=part_radius,
        eps=float(eps),
        c_key=c_key,
        keys=keys[perm],
        sp_center=np.asarray(sp_center, np.float32),
        sp_radius=np.asarray(sp_radius, np.float32),
        sp_start=sp_start,
        sp_key=np.asarray(sp_key, np.int64),
        sp_part=np.asarray(sp_part, np.int64),
    )


def ring_key_range(layout: IDistanceLayout, q_proj: np.ndarray, radius: float):
    """The B+-tree key windows a range-search sphere touches (host search).

    For each first-stage partition i the sphere (q, r) meets the rings with
    dis(q, O_i) - r <= ring * eps (+eps) <= dis(q, O_i) + r, skipping a
    partition the sphere misses. Returns a list of inclusive (key_lo,
    key_hi) windows, for the page accounting of the B+-tree descent."""
    windows = []
    for i in range(layout.part_center.shape[0]):
        dq = float(np.linalg.norm(q_proj - layout.part_center[i]))
        if dq - radius > layout.part_radius[i]:
            continue  # sphere misses the partition entirely
        lo_ring = max(0, int(np.floor(max(dq - radius, 0.0) / layout.eps)))
        hi_ring = int(np.floor((dq + radius) / layout.eps))
        windows.append((i * layout.c_key + lo_ring, i * layout.c_key + hi_ring))
    return windows
