"""Block-level quantized sketch for the verification prefilter; numpy copy
of `repro.core.sketch` (the same seed gives the same arrays, bit for bit).

Every data block (page) of the padded corpus is summarized by the centroid
of its valid rows, PQ-encoded, and given a reconstruction-error radius; at
query time ``est_b = <q, mu~_b>`` and Cauchy-Schwarz bounds every valid row
score of block b to ``[est_b - ||q||*err_b, est_b + ||q||*err_b]``.
"""
from __future__ import annotations

import numpy as np

from .idistance import _pairwise_d2, kmeans_np


def pick_subspaces(d: int, target: int = 16) -> int:
    """Largest divisor of ``d`` that is <= ``target`` (PQ needs sub_d * M = d)."""
    for m in range(min(target, d), 0, -1):
        if d % m == 0:
            return m
    return 1


def pq_train(train: np.ndarray, n_subspaces: int, n_codewords: int, *,
             iters: int = 8, seed: int = 0) -> np.ndarray:
    """Per-subspace k-means codebooks, zero-padded to ``n_codewords`` rows.

    Returns (n_subspaces, n_codewords, sub_d) float32. Subspace ``s`` trains
    with ``seed + s``.
    """
    train = np.asarray(train, np.float32)
    d = train.shape[1]
    if d % n_subspaces:
        raise ValueError(f"d={d} not divisible by n_subspaces={n_subspaces}")
    sub_d = d // n_subspaces
    codebooks = np.zeros((n_subspaces, n_codewords, sub_d), np.float32)
    for s in range(n_subspaces):
        sl = slice(s * sub_d, (s + 1) * sub_d)
        cb, _ = kmeans_np(train[:, sl], min(n_codewords, len(train)),
                          iters=iters, seed=seed + s)
        codebooks[s, :cb.shape[0]] = cb
    return codebooks


def pq_assign(x: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Nearest-codeword assignment against the (padded) codebooks.

    Returns (n, n_subspaces) int32 codes.
    """
    x = np.asarray(x, np.float32)
    n_subspaces, _, sub_d = codebooks.shape
    codes = np.zeros((x.shape[0], n_subspaces), np.int32)
    for s in range(n_subspaces):
        sl = slice(s * sub_d, (s + 1) * sub_d)
        codes[:, s] = _pairwise_d2(x[:, sl], codebooks[s]).argmin(1)
    return codes


def pq_decode(codebooks: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Decode (n, M) codes back to (n, d) float32 vectors."""
    n_subspaces = codebooks.shape[0]
    return np.concatenate(
        [codebooks[s][codes[:, s]] for s in range(n_subspaces)], axis=1)


def build_block_sketch(x_pad: np.ndarray, ids: np.ndarray, page_rows: int,
                       n_subspaces: int, n_codewords: int, seed: int = 0):
    """Build the per-block sketch over the padded/permuted corpus.

    Returns ``(sk_mu (NB, d), sk_codebooks (M, K, d/M), sk_codes (NB, M)
    int32, sk_err (NB,))``. Padding rows (ids < 0) are excluded from both the
    centroid mean and the error radius.
    """
    x = np.asarray(x_pad, np.float32)
    ids = np.asarray(ids)
    n_pad, d = x.shape
    nb = n_pad // page_rows
    xb = x.reshape(nb, page_rows, d)
    vb = (ids >= 0).reshape(nb, page_rows)
    cnt = np.maximum(vb.sum(1), 1)[:, None]
    mu = ((xb * vb[:, :, None]).sum(1) / cnt).astype(np.float32)
    codebooks = pq_train(mu, n_subspaces, n_codewords, iters=8, seed=seed)
    codes = pq_assign(mu, codebooks)
    mu_hat = pq_decode(codebooks, codes)
    diff = xb - mu_hat[:, None, :]
    dist = np.where(vb, np.sqrt((diff * diff).sum(-1)), 0.0)
    err = dist.max(1).astype(np.float32)
    return mu_hat, codebooks, codes, err
