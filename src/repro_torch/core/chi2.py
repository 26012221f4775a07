"""Chi-square CDF and inverse CDF for ProMIPS Conditions B and Test A;
port of `repro.core.chi2`.

``Psi_m(x) = P(m/2, x/2)``, the regularized lower incomplete gamma function
(`torch.special.gammainc`). The search threshold x_p = Psi_m^{-1}(p) is a
static pair (p, m), so the hot path uses the SciPy host value
`chi2_ppf_host`; `chi2_ppf` is the tensor bisection for any other caller.
"""
from __future__ import annotations

import torch


def chi2_cdf(x, m: float) -> torch.Tensor:
    """Psi_m(x): the CDF of chi-square with ``m`` degrees of freedom,
    elementwise in ``x`` (0 where x <= 0), as float32.

    The incomplete gamma function is evaluated in float64 and rounded once,
    so the result is within an f32 rounding of the exact value (float32
    evaluations, the JAX package's included, are off by up to ~6e-6
    relative at m = 30)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    x64 = x.double()
    a = torch.full_like(x64, m / 2.0)
    cdf = torch.special.gammainc(a, torch.clamp(x64, min=0.0) / 2.0).float()
    return torch.where(x > 0, cdf, torch.zeros_like(x))


def chi2_ppf_host(p: float, m: float) -> float:
    """Psi_m^{-1}(p) on host (SciPy). Use for static thresholds."""
    from scipy.stats import chi2 as _chi2

    return float(_chi2.ppf(p, m))


def chi2_ppf(p, m: int, iters: int = 96) -> torch.Tensor:
    """Psi_m^{-1}(p) by bisection on `chi2_cdf`, elementwise, in float32.

    The bracket [0, m + 24 sqrt(2m) + 64] covers p < 1 - 1e-12 for the small
    m (<= 32) ProMIPS uses."""
    p = torch.as_tensor(p, dtype=torch.float32)
    lo = torch.zeros_like(p)
    hi = torch.full_like(p, float(m + 24.0 * (2.0 * m) ** 0.5 + 64.0))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = chi2_cdf(mid, m) < p
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)
