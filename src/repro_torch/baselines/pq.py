"""PQ-based baseline (paper §VIII-A1): H2-ALSH's asymmetric QNF transform to
reduce MIPS -> NN, then an IVF-PQ pipeline in the transformed space — coarse
inverted lists, product quantisation (16 subspaces x 256 centroids, 16
probed cells, per the paper's setting), ADC lookup-table scan of the probed
lists, exact re-rank of the survivors by true inner product.

Page model: PQ codes of a probed list stream sequentially (code pages);
re-ranked candidates touch their data pages. Copy of `repro.baselines.pq`,
over the port's own `kmeans_np`, `pq_train` and `pq_assign`.
"""
from __future__ import annotations

import time

import numpy as np

from ..core.idistance import kmeans_np
from ..core.sketch import pq_assign, pq_train


class PQBased:
    name = "pq-based"

    def __init__(self, n_subspaces: int = 16, n_centroids: int = 256,
                 n_cells: int = 64, n_probe: int = 16, rerank: int = 256,
                 page_bytes: int = 4096, seed: int = 0):
        self.m_sub, self.ksub = n_subspaces, n_centroids
        self.n_cells, self.n_probe, self.rerank = n_cells, n_probe, rerank
        self.page_bytes, self.seed = page_bytes, seed

    def build(self, x: np.ndarray):
        t0 = time.time()
        x = np.ascontiguousarray(x, np.float32)
        n, d = x.shape
        self.page_rows = max(1, self.page_bytes // (4 * d))
        norms = np.linalg.norm(x, axis=1)
        self.m_max = float(norms.max()) if n else 1.0
        aug = np.sqrt(np.maximum(self.m_max ** 2 - norms ** 2, 0.0))
        xq = np.concatenate([x, aug[:, None]], axis=1)  # QNF -> NN space
        dq = d + 1
        pad = (-dq) % self.m_sub
        if pad:
            xq = np.concatenate([xq, np.zeros((n, pad), np.float32)], axis=1)
        self.dq = dq + pad
        self.sub_d = self.dq // self.m_sub

        cells = min(self.n_cells, n)
        self.coarse, assign = kmeans_np(xq, cells, iters=10, seed=self.seed)
        resid = xq - self.coarse[assign]
        rng = np.random.RandomState(self.seed + 1)
        train = resid[rng.choice(n, size=min(n, 4000), replace=False)]
        self.codebooks = pq_train(train, self.m_sub, self.ksub, iters=8,
                                  seed=self.seed)
        codes = pq_assign(resid, self.codebooks).astype(np.uint8)
        self.lists = [np.nonzero(assign == c)[0] for c in range(cells)]
        self.codes = codes
        self.x = x
        self.xq = xq
        self.index_bytes = (self.coarse.nbytes + self.codebooks.nbytes +
                            codes.nbytes + 8 * n)
        self.build_seconds = time.time() - t0
        return self

    def search(self, q: np.ndarray, k: int = 10):
        q = np.asarray(q, np.float32)
        qa = np.concatenate([q, np.zeros(self.dq - len(q), np.float32)])
        d_cell = ((self.coarse - qa) ** 2).sum(1)
        probe = np.argsort(d_cell, kind="stable")[: self.n_probe]
        pages, cand = 0, 0
        all_rows, all_adc = [], []
        for c in probe:
            rows = self.lists[int(c)]
            if len(rows) == 0:
                continue
            resid_q = qa - self.coarse[c]
            lut = np.zeros((self.m_sub, self.ksub), np.float32)
            for s in range(self.m_sub):
                sl = slice(s * self.sub_d, (s + 1) * self.sub_d)
                lut[s] = ((self.codebooks[s] - resid_q[sl]) ** 2).sum(1)
            adc = lut[np.arange(self.m_sub)[None, :], self.codes[rows]].sum(1)
            all_rows.append(rows)
            all_adc.append(adc)
            cand += len(rows)
            code_page_rows = max(1, self.page_bytes // self.m_sub)
            pages += -(-len(rows) // code_page_rows)  # code pages stream
        if not all_rows:
            return np.full(k, -1), np.full(k, -np.inf), {"pages": pages, "candidates": 0}
        rows = np.concatenate(all_rows)
        adc = np.concatenate(all_adc)
        keep = rows[np.argsort(adc, kind="stable")[: self.rerank]]
        resident = set()
        for pg in np.unique(keep // self.page_rows):
            resident.add(int(pg))
            pages += 1
        scores = self.x[keep] @ q
        sel = np.argsort(-scores, kind="stable")[:k]
        ids = keep[sel]
        out_s = scores[sel]
        if len(ids) < k:
            ids = np.pad(ids, (0, k - len(ids)), constant_values=-1)
            out_s = np.pad(out_s, (0, k - len(out_s)), constant_values=-np.inf)
        return ids, out_s, {"pages": pages, "candidates": cand}
