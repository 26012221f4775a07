"""Accuracy metrics from the paper's evaluation (Section VIII-A3); numpy
copy of `repro.core.metrics`."""
from __future__ import annotations

import numpy as np


def overall_ratio(returned_scores: np.ndarray, exact_scores: np.ndarray) -> float:
    """(1/k) sum_i <o_i, q> / <o_i*, q>, the paper's 'Overall Ratio'.

    Both arrays are descending top-k inner products for one query, compared
    rank by rank. A rank with a non-positive exact score counts 1, and each
    ratio is clipped into [0, 1]."""
    r = np.asarray(returned_scores, np.float64)
    e = np.asarray(exact_scores, np.float64)
    k = min(len(r), len(e))
    r, e = r[:k], e[:k]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(e > 0, r / e, 1.0)
    return float(np.clip(ratio, 0.0, 1.0).mean())


def recall_at_k(returned_ids: np.ndarray, exact_ids: np.ndarray) -> float:
    """t/k where t = |returned ∩ exact top-k|, the paper's 'Recall'."""
    k = len(exact_ids)
    if k == 0:
        return 1.0
    return len(set(map(int, returned_ids[:k])) & set(map(int, exact_ids))) / k
