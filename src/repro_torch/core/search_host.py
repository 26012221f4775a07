"""Host-mode ProMIPS search: the paper's sequential semantics and page
accounting; numpy port of `repro.core.search_host`.

The paper's Algorithm 1 (MIP-Search-I, incremental NN with per-point
condition tests) and Algorithms 2+3 (Quick-Probe + range-search
MIP-Search-II), and the progressive norm-adaptive search. It reproduces the
paper's page-access metric exactly: a page is `page_rows` contiguous rows
of the sorted layout (4 KB by default), and every fetch of a row whose page
is not resident yet counts one access. It stays on the host: a caller asks
for it with ``search_path="host"`` or `ProMIPS.search_host*`.

The search math is numpy in the dtypes of the JAX package's ``xp=np`` path
(float64 scalars, float32 arrays), so ids, scores and every `HostStats`
field equal the JAX module's bit for bit; the port's torch `search_common`
holds the same formulas for the device paths.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .chi2 import chi2_ppf_host
from .idistance import ring_key_range
from .index import ProMIPSIndex
from .quick_probe import pack_codes_np
from .search_common import MIN_SCORE

# -- the search math on numpy (`search_common` with xp=np) --------------------


def _condition_a(best_ip, max_l2sq, q_l2sq, c: float):
    return max_l2sq + q_l2sq - 2.0 * best_ip / c <= 0.0


def _denominator(best_ip, max_l2sq, q_l2sq, c: float):
    return max_l2sq + q_l2sq - 2.0 * np.maximum(best_ip, MIN_SCORE) / c


def _condition_b(proj_dist_sq, best_ip, max_l2sq, q_l2sq, c: float, x_p):
    denom = _denominator(best_ip, max_l2sq, q_l2sq, c)
    return (denom <= 0.0) | (proj_dist_sq >= x_p * denom)


def _compensation_radius(best_ip, max_l2sq, q_l2sq, c: float, x_p):
    denom = _denominator(best_ip, max_l2sq, q_l2sq, c)
    return np.sqrt(np.maximum(x_p * denom, 0.0))


def _adaptive_radii(local_max_l2sq, best_ip, q_l2sq, c: float, x_p,
                    cs_prune: bool = False):
    denom = _denominator(best_ip, local_max_l2sq, q_l2sq, c)
    r = np.sqrt(np.maximum(x_p * denom, 0.0))
    if cs_prune:
        ok = np.sqrt(local_max_l2sq) * np.sqrt(q_l2sq) >= best_ip
        r = np.where(ok, r, -1.0)
    return r


def _sphere_select(center_dist, region_radius, radius):
    return (center_dist <= radius + region_radius) & (radius >= 0.0)


def _topk_merge(top_scores, top_rows, scores, rows, k: int):
    """Merge into a running descending top-k; ties to the earlier entry
    (carried first, then new rows in order)."""
    s = np.concatenate([top_scores, scores])
    r = np.concatenate([top_rows, rows])
    idx = np.argsort(-s, kind="stable")[:k]
    return s[idx], r[idx]


@dataclass
class HostStats:
    pages: int = 0
    candidates: int = 0
    probe_passed: bool = False
    used_round2: bool = False
    rounds: int = 1
    stopped_by: str = "exhausted"  # "A" | "B" | "exhausted"
    radius0: float = 0.0
    radius1: float = 0.0
    _resident: set = field(default_factory=set)

    def touch_rows(self, rows: np.ndarray, page_rows: int):
        fresh = set(np.unique(rows // page_rows).tolist()) - self._resident
        self._resident |= fresh
        self.pages += len(fresh)

    def to_dict(self) -> dict:
        """Normalized accounting (`core.stats.stats_totals`); one query."""
        from .stats import stats_totals
        return stats_totals(self.pages, self.candidates,
                            self.stopped_by == "exhausted")


class HostSearcher:
    """Shared state for the three search algorithms over one index (its
    host numpy arrays)."""

    def __init__(self, index: ProMIPSIndex):
        self.idx = index
        a = index.arrays
        self.meta = index.meta
        self.layout = index.layout
        n = self.meta.n
        self.x = np.asarray(a.x[:n])
        self.p = np.asarray(a.p[:n])
        self.ids = np.asarray(a.ids[:n])
        self.max_l2sq = float(a.max_l2sq)
        self.g_code = np.asarray(a.g_code)
        self.g_min_l1 = np.asarray(a.g_min_l1)
        self.g_rep_proj = np.asarray(a.g_rep_proj)
        self.g_rep_row = np.asarray(a.g_rep_row)
        self.sp_center = np.asarray(a.sp_center)
        self.sp_radius = np.asarray(a.sp_radius)
        self.sp_start = np.asarray(a.sp_start)
        self.sp_max_l2sq = np.asarray(a.sp_max_l2sq)
        self.proj = np.asarray(a.a)
        self._chi2_cache: dict[float, float] = {}

    # -- shared helpers -----------------------------------------------------
    def _x_p(self, p: float) -> float:
        if p not in self._chi2_cache:
            self._chi2_cache[p] = chi2_ppf_host(p, self.meta.m)
        return self._chi2_cache[p]

    def _condition_a(self, best_ip: float, q_l2sq: float, c: float) -> bool:
        return bool(_condition_a(best_ip, self.max_l2sq, q_l2sq, c))

    def _condition_b(self, proj_d2: float, best_ip: float, q_l2sq: float,
                     c: float, x_p: float) -> bool:
        return bool(_condition_b(proj_d2, best_ip, self.max_l2sq, q_l2sq,
                                 c, x_p))

    # -- Algorithm 2: Quick-Probe ------------------------------------------
    def quick_probe(self, q: np.ndarray, c: float, p: float, stats: HostStats):
        """Sequential ascending-LB group scan, as in Algorithm 2."""
        m = self.meta.m
        q_proj = q @ self.proj
        q_code = pack_codes_np(q_proj[None, :])[0]
        q_l1 = float(np.abs(q).sum())
        x_p = self._x_p(p)

        xor = self.g_code ^ q_code
        bits = ((xor[:, None] >> np.arange(m, dtype=np.uint32)) & 1).astype(np.float32)
        lb = bits @ np.abs(q_proj).astype(np.float32) / np.sqrt(m)

        order = np.argsort(lb, kind="stable")  # ascending lower bound
        best_val, best_g = -np.inf, order[0]
        chosen = -1
        for g in order:
            val = lb[g] ** 2 / max(c * (self.g_min_l1[g] + q_l1) ** 2, 1e-30)
            if val >= x_p:  # Test A
                chosen = g
                stats.probe_passed = True
                break
            if val > best_val:
                best_val, best_g = val, g
        if chosen < 0:
            chosen = best_g
        rep_row = int(self.g_rep_row[chosen])
        # fetching the representative's projected point costs one page access
        stats.touch_rows(np.asarray([rep_row]), self.meta.page_rows)
        radius = float(np.linalg.norm(self.p[rep_row] - q_proj))
        stats.radius0 = radius
        return q_proj, radius

    # -- Algorithm 3: MIP-Search-II ------------------------------------------
    def search(self, q: np.ndarray, k: int = 10, c: float | None = None,
               p: float | None = None, norm_adaptive: bool = False,
               cs_prune: bool = False):
        """Quick-Probe + range search + compensation round.

        ``norm_adaptive`` / ``cs_prune`` turn on the per-sub-partition radii
        and Cauchy-Schwarz pruning; the defaults are the paper's search.
        Returns (ids (k,), scores (k,), HostStats)."""
        meta = self.meta
        c = meta.c if c is None else c
        p = meta.p if p is None else p
        x_p = self._x_p(p)
        stats = HostStats()
        q = np.asarray(q, np.float32)
        q_l2sq = float(q @ q)
        q_proj, r = self.quick_probe(q, c, p, stats)

        top_s = np.full(k, -np.inf)
        top_r = np.full(k, -1, np.int64)

        def run_round(radius, skip_sp: set[int]):
            nonlocal top_s, top_r
            d_sp = np.linalg.norm(self.sp_center - q_proj[None, :], axis=1)
            radius = np.broadcast_to(np.asarray(radius, np.float64), d_sp.shape)
            sel = np.nonzero(_sphere_select(d_sp, self.sp_radius, radius))[0]
            done_a = False
            visited = set()
            for s in sel:
                if s in skip_sp:
                    continue
                visited.add(int(s))
                lo, hi = int(self.sp_start[s]), int(self.sp_start[s + 1])
                rows = np.arange(lo, hi)
                stats.touch_rows(rows, meta.page_rows)
                scores = self.x[lo:hi] @ q
                stats.candidates += hi - lo
                top_s, top_r = _topk_merge(top_s, top_r, scores, rows, k)
                if self._condition_a(top_s[k - 1], q_l2sq, c):
                    done_a = True
                    break
            return done_a, visited

        done_a, visited = run_round(r, set())
        if done_a:
            stats.stopped_by = "A"
        else:
            # Condition B with the Quick-Probe radius (Algorithm 3 line 12)
            if self._condition_b(r * r, top_s[k - 1], q_l2sq, c, x_p):
                stats.stopped_by = "B"
            else:
                s_k = top_s[k - 1]
                if norm_adaptive:
                    r1 = _adaptive_radii(self.sp_max_l2sq, s_k, q_l2sq, c,
                                         x_p, cs_prune=cs_prune)
                    stats.radius1 = float(np.max(r1))
                else:
                    r1 = float(_compensation_radius(s_k, self.max_l2sq,
                                                    q_l2sq, c, x_p))
                    stats.radius1 = r1
                stats.used_round2, stats.rounds = True, 2
                done_a, _ = run_round(r1, visited)
                stats.stopped_by = "A" if done_a else "B"
        valid = top_r >= 0
        ids = np.where(valid, self.ids[np.maximum(top_r, 0)], -1)
        return ids, np.where(valid, top_s, -np.inf), stats

    # -- progressive norm-adaptive search ------------------------------------
    def search_progressive(self, q: np.ndarray, k: int = 10,
                           c: float | None = None, p: float | None = None,
                           cs_prune: bool = True):
        """One pass over the sub-partitions in ascending projected distance,
        each tested against its norm-adaptive Condition-B radius under the
        running k-th score (radii only shrink as it grows, so a
        sub-partition disqualified at its visit stays so). Condition A
        still stops the walk. Returns (ids, scores, HostStats)."""
        meta = self.meta
        c = meta.c if c is None else c
        p = meta.p if p is None else p
        x_p = self._x_p(p)
        stats = HostStats()
        q = np.asarray(q, np.float32)
        q_l2sq = float(q @ q)
        q_proj = q @ self.proj
        stats.probe_passed = False  # progressive mode does not use Quick-Probe

        d_sp = np.linalg.norm(self.sp_center - q_proj[None, :], axis=1)
        order = np.argsort(d_sp, kind="stable")
        top_s = np.full(k, -np.inf)
        top_r = np.full(k, -1, np.int64)
        for s in order:
            s_k = top_s[k - 1]
            m_sp = float(self.sp_max_l2sq[s])
            r_sp = _adaptive_radii(m_sp, s_k, q_l2sq, c, x_p, cs_prune=cs_prune)
            if not _sphere_select(d_sp[s], self.sp_radius[s], r_sp):
                continue
            lo, hi = int(self.sp_start[s]), int(self.sp_start[s + 1])
            rows = np.arange(lo, hi)
            stats.touch_rows(rows, meta.page_rows)
            scores = self.x[lo:hi] @ q
            stats.candidates += hi - lo
            top_s, top_r = _topk_merge(top_s, top_r, scores, rows, k)
            if self._condition_a(top_s[k - 1], q_l2sq, c):
                stats.stopped_by = "A"
                break
        else:
            stats.stopped_by = "B"
        valid = top_r >= 0
        ids = np.where(valid, self.ids[np.maximum(top_r, 0)], -1)
        return ids, np.where(valid, top_s, -np.inf), stats

    # -- Algorithm 1: MIP-Search-I (incremental NN baseline) ----------------
    def search_incremental(self, q: np.ndarray, k: int = 10,
                           c: float | None = None, p: float | None = None):
        """Algorithm 1: incremental NN in the projected space with per-point
        Condition A/B tests, the cost Quick-Probe avoids. Returns (ids,
        scores, HostStats)."""
        meta = self.meta
        c = meta.c if c is None else c
        p = meta.p if p is None else p
        x_p = self._x_p(p)
        stats = HostStats()
        q = np.asarray(q, np.float32)
        q_l2sq = float(q @ q)
        q_proj = q @ self.proj
        d2 = ((self.p - q_proj[None, :]) ** 2).sum(axis=1)
        order = np.argsort(d2, kind="stable")  # idealized incremental NN

        top_s = np.full(k, -np.inf)
        top_r = np.full(k, -1, np.int64)
        for row in order:
            # fetching the point (projected for the test, original for the
            # inner product) touches its page
            stats.touch_rows(np.asarray([row]), meta.page_rows)
            s = float(self.x[row] @ q)
            stats.candidates += 1
            if s > top_s[k - 1]:
                j = int(np.searchsorted(-top_s, -s))
                top_s = np.insert(top_s, j, s)[:k]
                top_r = np.insert(top_r, j, row)[:k]
            if self._condition_a(top_s[k - 1], q_l2sq, c):
                stats.stopped_by = "A"
                break
            if self._condition_b(float(d2[row]), top_s[k - 1], q_l2sq, c, x_p):
                stats.stopped_by = "B"
                break
        valid = top_r >= 0
        ids = np.where(valid, self.ids[np.maximum(top_r, 0)], -1)
        return ids, np.where(valid, top_s, -np.inf), stats

    # -- B+-tree accounting helper ------------------------------------------
    def btree_key_windows(self, q: np.ndarray, radius: float):
        """Key windows the B+-tree descent would touch (index-page metric)."""
        return ring_key_range(self.layout, q @ self.proj, radius)


__all__ = ["HostSearcher", "HostStats"]
