"""The one normalized search-accounting contract; port of
`repro.core.stats`.

Stats types implement ``to_dict()`` by calling :func:`stats_totals`, so the
keys are defined in one place. It is also the feed of the ``search.*``
counters of `obs.metrics` while the registry is enabled (one bool check
when it is not).
"""
from __future__ import annotations

import numpy as np
import torch

from ..obs import metrics as _metrics


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def stats_totals(pages, candidates, exhausted, queries=None) -> dict:
    """Batch totals as python ints from per-query tensors or arrays (or
    scalars, where ``queries`` is then 1). Callers whose totals are already
    summed pass ``queries`` explicitly."""
    pages = _host(pages)
    totals = {
        "pages": int(pages.sum()),
        "candidates": int(_host(candidates).sum()),
        "exhausted": int(_host(exhausted).sum()),
        "queries": int(pages.size) if queries is None else int(queries),
    }
    _metrics.observe_search(totals)
    return totals


__all__ = ["stats_totals"]
