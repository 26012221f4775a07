"""H2-ALSH (Huang et al., KDD'18) benchmark implementation.

Structure-faithful NumPy version: homocentric-hypersphere norm partitions
(geometric norm ranges with ratio c0), the error-free QNF asymmetric
transform per partition (append sqrt(M_j^2 - ||x||^2); query scaled), and a
QALSH-style E2LSH candidate search inside each partition. Partitions are
visited in descending max-norm order with the M_j * ||q|| upper-bound early
stop — the method's signature trick.

Page accounting matches ProMIPS's model: candidate fetches touch 4 KB pages
of the partition-ordered data layout; every LSH table lookup touches one
index page per probed bucket.

Copy of `repro.baselines.h2_alsh`.
"""
from __future__ import annotations

import time

import numpy as np


class H2ALSH:
    name = "h2-alsh"

    def __init__(self, c0: float = 2.0, n_tables: int = 16, w: float = 4.0,
                 multiprobe: int = 1, page_bytes: int = 4096, seed: int = 0):
        self.c0, self.n_tables, self.w = c0, n_tables, w
        self.multiprobe = multiprobe
        self.page_bytes, self.seed = page_bytes, seed

    def build(self, x: np.ndarray):
        t0 = time.time()
        x = np.ascontiguousarray(x, np.float32)
        n, d = x.shape
        self.d = d
        self.page_rows = max(1, self.page_bytes // (4 * d))
        rng = np.random.RandomState(self.seed)
        norms = np.linalg.norm(x, axis=1)
        order = np.argsort(-norms, kind="stable")
        m_max = norms[order[0]] if n else 1.0

        # geometric norm ranges: (M/c0^{j+1}, M/c0^j]
        bounds = []
        hi = m_max
        while True:
            lo = hi / self.c0
            bounds.append((hi, lo))
            if lo < max(1e-6 * m_max, 1e-12) or len(bounds) > 40:
                break
            hi = lo
        self.parts = []
        base = 0
        ptr = 0
        self.perm = order
        self.x = x[order]
        self.norms = norms[order]
        for hi, lo in bounds:
            end = ptr
            while end < n and self.norms[end] > lo - 1e-12:
                end += 1
            if end > ptr:
                rows = np.arange(ptr, end)
                m_j = self.norms[ptr]
                aug = np.sqrt(np.maximum(m_j ** 2 - self.norms[rows] ** 2, 0.0))
                xq = np.concatenate([self.x[rows], aug[:, None]], axis=1)  # QNF
                a = rng.standard_normal((d + 1, self.n_tables)).astype(np.float32)
                b = rng.rand(self.n_tables).astype(np.float32) * self.w
                codes = np.floor((xq @ a + b) / (self.w * m_j)).astype(np.int64)
                tables = []
                for t in range(self.n_tables):
                    buckets: dict[int, np.ndarray] = {}
                    for key in np.unique(codes[:, t]):
                        buckets[int(key)] = rows[codes[:, t] == key]
                    tables.append(buckets)
                self.parts.append(dict(rows=rows, m=m_j, a=a, b=b, tables=tables))
            ptr = end
            if ptr >= n:
                break
        self.index_bytes = sum(
            p["a"].nbytes + 8 * len(p["rows"]) * self.n_tables for p in self.parts
        )
        self.build_seconds = time.time() - t0
        return self

    def search(self, q: np.ndarray, k: int = 10):
        q = np.asarray(q, np.float32)
        qn = np.linalg.norm(q)
        top_s = np.full(k, -np.inf)
        top_i = np.full(k, -1, np.int64)
        pages, cand = 0, 0
        resident: set[int] = set()
        for part in self.parts:  # descending max norm
            if part["m"] * qn <= top_s[k - 1]:  # upper-bound early stop
                break
            qa = np.concatenate([q * part["m"], [0.0]])
            keys = np.floor((qa @ part["a"] + part["b"]) / (self.w * part["m"])).astype(np.int64)
            cand_rows: list[np.ndarray] = []
            for t, buckets in enumerate(part["tables"]):
                pages += 1  # bucket lookup = one index page
                for dk in range(-self.multiprobe, self.multiprobe + 1):
                    hit = buckets.get(int(keys[t]) + dk)
                    if hit is not None:
                        cand_rows.append(hit)
            if not cand_rows:
                continue
            rows = np.unique(np.concatenate(cand_rows))
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
