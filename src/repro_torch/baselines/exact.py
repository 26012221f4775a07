"""Exact MIPS oracle: a full corpus scan in numpy; copy of
`repro.baselines.exact`. Ground truth for overall ratio and recall, and the
page-access upper bound (a linear scan touches every page once)."""
from __future__ import annotations

import numpy as np


class ExactMIPS:
    name = "exact"

    def __init__(self, page_bytes: int = 4096):
        self.page_bytes = page_bytes

    def build(self, x: np.ndarray):
        self.x = np.ascontiguousarray(x, np.float32)
        n, d = x.shape
        self.page_rows = max(1, self.page_bytes // (4 * d))
        self.n_pages = -(-n // self.page_rows)
        self.index_bytes = 0  # no index
        self.build_seconds = 0.0
        return self

    def search(self, q: np.ndarray, k: int = 10):
        scores = self.x @ q
        idx = np.argpartition(-scores, min(k, len(scores) - 1))[:k]
        idx = idx[np.argsort(-scores[idx], kind="stable")]
        return idx, scores[idx], {"pages": self.n_pages, "candidates": len(self.x)}


def exact_topk(x: np.ndarray, queries: np.ndarray, k: int):
    """(ids (B,k), scores (B,k)) for a query batch — shared test helper."""
    scores = queries @ x.T  # (B, n)
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(scores, idx, axis=1)
