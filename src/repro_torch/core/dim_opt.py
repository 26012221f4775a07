"""Optimized projected dimension (paper Section V-B); copy of
`repro.core.dim_opt`.

Quick-Probe cost model: f(m) = 2^m (m+1) + n / 2^m, convex in m.
"""
from __future__ import annotations


def quick_probe_cost(m: int, n: int) -> float:
    return float(2**m) * (m + 1) + n / float(2**m)


def optimized_projected_dimension(n: int, m_min: int = 2, m_max: int = 24) -> int:
    """m* = argmin_m 2^m (m+1) + n / 2^m over the practical range."""
    best_m, best_cost = m_min, float("inf")
    for m in range(m_min, m_max + 1):
        cost = quick_probe_cost(m, n)
        if cost < best_cost:
            best_m, best_cost = m, cost
    return best_m
