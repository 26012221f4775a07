"""2-stable random projections (paper Definition 2); numpy copy of
`repro.core.projections`."""
from __future__ import annotations

import numpy as np


def make_projection(d: int, m: int, seed: int = 0) -> np.ndarray:
    """(d, m) matrix of i.i.d. standard normals. Deterministic in ``seed``."""
    rng = np.random.RandomState(seed)
    return rng.standard_normal((d, m)).astype(np.float32)


def project(x, a):
    """P(x) = x @ A; (..., d) -> (..., m) for numpy arrays or tensors."""
    return x @ a
