"""Deterministic synthetic vector corpora (numpy copy of
`repro.data.synthetic.mf_factors`: the same seed gives the same floats)."""
from __future__ import annotations

import numpy as np


def mf_factors(n: int, d: int, rank: int, *, decay: float = 0.3, seed: int = 0,
               norm_tail: float = 0.0) -> np.ndarray:
    """PureSVD-style latent factors: U diag(s) V with decaying spectrum.
    ``norm_tail`` > 0 adds a lognormal per-point scale (long-tail norms)."""
    rng = np.random.RandomState(seed)
    u = rng.standard_normal((n, rank))
    v = rng.standard_normal((rank, d))
    spec = np.exp(-decay * np.arange(rank))
    x = (u * spec) @ v
    if norm_tail > 0:
        x *= rng.lognormal(0.0, norm_tail, size=(n, 1))
    return x.astype(np.float32)
