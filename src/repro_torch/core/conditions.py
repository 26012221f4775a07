"""ProMIPS stopping conditions (paper Section IV); port of
`repro.core.conditions`.

Condition A (Theorem 1, deterministic):
    ||o_M||^2 + ||q||^2 - 2<o_i,q>/c <= 0
Condition B (Theorem 2, probabilistic):
    Psi_m( dis^2(P(o_i),P(q)) / (||o_M||^2 + ||q||^2 - 2<o_max,q>/c) ) >= p

For c-k-AMIP both use the running k-th best inner product. The arithmetic
lives in `search_common`; this module re-exports it and adds the form of
Condition B with the chi-square CDF evaluated on tensors (any p).
"""
from __future__ import annotations

import torch

from .chi2 import chi2_cdf
from .search_common import (  # noqa: F401  (re-exported public API)
    compensation_radius,
    condition_a,
    condition_b_denominator,
)
from .search_common import condition_b as condition_b_threshold  # noqa: F401


def condition_b(proj_dist_sq, best_ip, max_l2sq, q_l2sq, c: float, p: float,
                m: int):
    """Theorem 2 test through the chi-square CDF. True => stop with the
    probability-p guarantee. The search paths use the static threshold form
    `condition_b_threshold` instead."""
    denom = condition_b_denominator(torch.as_tensor(best_ip), max_l2sq,
                                    q_l2sq, c)
    # denom <= 0 is exactly Condition A, already guaranteed
    ratio = proj_dist_sq / torch.clamp(denom, min=1e-30)
    return torch.where(denom <= 0.0, torch.ones_like(denom, dtype=torch.bool),
                       chi2_cdf(ratio, m) >= p)
