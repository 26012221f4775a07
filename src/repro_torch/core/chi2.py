"""Chi-square inverse CDF for the static search threshold x_p = Psi_m^{-1}(p)
(Conditions B and Test A); copy of `repro.core.chi2.chi2_ppf_host`."""
from __future__ import annotations


def chi2_ppf_host(p: float, m: float) -> float:
    """Psi_m^{-1}(p) on host (SciPy)."""
    from scipy.stats import chi2 as _chi2

    return float(_chi2.ppf(p, m))
