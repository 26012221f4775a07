"""Norm-Ranging LSH (Yan et al., NeurIPS'18) benchmark implementation.

Splits the dataset into equal-size subsets by norm rank; each subset gets a
Simple-LSH symmetric transform (normalise by the subset max norm, append
sqrt(1 - ||x||^2/M_i^2)) and SimHash signatures (16-bit codes in the paper's
setting). The query probes subsets in descending upper-bound order
(M_i * ||q||), ranking candidates by Hamming distance — the single-table
multi-probe strategy the paper credits for its low page counts.

Copy of `repro.baselines.range_lsh`.
"""
from __future__ import annotations

import time

import numpy as np


class RangeLSH:
    name = "range-lsh"

    def __init__(self, n_subsets: int = 32, code_bits: int = 16,
                 probe_radius: int = 4, page_bytes: int = 4096, seed: int = 0):
        self.n_subsets, self.code_bits = n_subsets, code_bits
        self.probe_radius = probe_radius
        self.page_bytes, self.seed = page_bytes, seed

    def build(self, x: np.ndarray):
        t0 = time.time()
        x = np.ascontiguousarray(x, np.float32)
        n, d = x.shape
        self.page_rows = max(1, self.page_bytes // (4 * d))
        rng = np.random.RandomState(self.seed)
        norms = np.linalg.norm(x, axis=1)
        order = np.argsort(-norms, kind="stable")  # descending norm layout
        self.x, self.perm, self.norms = x[order], order, norms[order]
        self.a = rng.standard_normal((d + 1, self.code_bits)).astype(np.float32)
        splits = np.array_split(np.arange(n), self.n_subsets)
        self.subsets = []
        for rows in splits:
            if len(rows) == 0:
                continue
            m_i = self.norms[rows[0]]
            xn = self.x[rows] / max(m_i, 1e-12)
            aug = np.sqrt(np.maximum(1.0 - (xn * xn).sum(1), 0.0))
            xh = np.concatenate([xn, aug[:, None]], axis=1)  # Simple-LSH
            codes = ((xh @ self.a) >= 0).astype(np.uint32)
            packed = (codes << np.arange(self.code_bits, dtype=np.uint32)).sum(1)
            self.subsets.append(dict(rows=rows, m=m_i, codes=packed.astype(np.uint32)))
        self.index_bytes = self.a.nbytes + sum(4 * len(s["rows"]) for s in self.subsets)
        self.build_seconds = time.time() - t0
        return self

    def search(self, q: np.ndarray, k: int = 10):
        q = np.asarray(q, np.float32)
        qn = np.linalg.norm(q)
        qh = np.concatenate([q / max(qn, 1e-12), [0.0]])
        qcode_bits = (qh @ self.a) >= 0
        qcode = (qcode_bits.astype(np.uint32) <<
                 np.arange(self.code_bits, dtype=np.uint32)).sum()
        top_s = np.full(k, -np.inf)
        top_i = np.full(k, -1, np.int64)
        pages, cand = 0, 0
        resident: set[int] = set()
        for sub in self.subsets:  # descending max-norm order
            if sub["m"] * qn <= top_s[k - 1]:
                break
            pages += 1  # signature scan of the subset = one index page
            ham = np.zeros(len(sub["rows"]), np.int32)
            xor = sub["codes"] ^ np.uint32(qcode)
            for b in range(self.code_bits):
                ham += ((xor >> np.uint32(b)) & 1).astype(np.int32)
            # hamming-ranked probing: radius plus a top-fraction floor
            n_take = max(int(np.sum(ham <= self.probe_radius)), max(16, len(ham) // 16))
            rows = sub["rows"][np.argsort(ham, kind="stable")[:n_take]]
            if len(rows) == 0:
                continue
            for pg in np.unique(rows // self.page_rows):
                if pg not in resident:
                    resident.add(int(pg))
                    pages += 1
            scores = self.x[rows] @ q
            cand += len(rows)
            merged_s = np.concatenate([top_s, scores])
            merged_i = np.concatenate([top_i, self.perm[rows]])
            sel = np.argsort(-merged_s, kind="stable")[:k]
            top_s, top_i = merged_s[sel], merged_i[sel]
        return top_i, top_s, {"pages": pages, "candidates": cand}
