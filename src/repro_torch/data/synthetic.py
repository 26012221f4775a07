"""Deterministic synthetic corpora and token streams (numpy copy of
`repro.data.synthetic`: the same seed gives the same floats and tokens).

Shape-matched proxies of the paper's four datasets (Table III): Netflix and
Yahoo PureSVD MF factors, P53 wide biology vectors, SIFT descriptors. The
MF-style generator gives low effective rank and long-tail norms, the regime
the paper's conditions and the norm-adaptive extensions are sensitive to.
`TokenStream` and `lm_batch` feed the LM trainer.
"""
from __future__ import annotations

from dataclasses import dataclass

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


# Paper Table III proxies: ``n`` is the published size, ``scaled_n`` the
# smaller size the JAX benchmark harness runs on the CPU.
DATASETS = {
    "netflix": dict(n=17770, d=300, rank=32, decay=0.15, norm_tail=0.3, scaled_n=17770),
    "yahoo": dict(n=624961, d=300, rank=32, decay=0.15, norm_tail=0.3, scaled_n=100000),
    "p53": dict(n=31420, d=5408, rank=64, decay=0.08, norm_tail=0.2, scaled_n=8000),
    "sift": dict(n=11164866, d=128, rank=48, decay=0.05, norm_tail=0.15, scaled_n=200000),
}


def paper_dataset(name: str, *, scaled: bool = True, seed: int = 0):
    """The (n, d) corpus of one Table III proxy, at ``scaled_n`` rows or,
    with ``scaled=False``, at the published n."""
    cfg = DATASETS[name]
    n = cfg["scaled_n"] if scaled else cfg["n"]
    x = mf_factors(n, cfg["d"], cfg["rank"], decay=cfg["decay"],
                   norm_tail=cfg["norm_tail"], seed=seed)
    if name == "sift":
        x = np.abs(x)  # SIFT descriptors are non-negative
    return x


def paper_queries(name: str, n_queries: int = 100, *, seed: int = 1):
    """Queries from the same factor family as `paper_dataset` (no norm
    tail)."""
    cfg = DATASETS[name]
    q = mf_factors(n_queries, cfg["d"], cfg["rank"], decay=cfg["decay"], seed=seed)
    if name == "sift":
        q = np.abs(q)
    return q


# ---------------------------------------------------------------------------
# LM token pipeline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TokenStream:
    """Deterministic zipf-ish token stream; batch(step) is pure in (seed, step)."""
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    zipf_a: float = 1.3

    def batch_at(self, step: int, host: int = 0, n_hosts: int = 1):
        rng = np.random.RandomState((self.seed * 1_000_003 + step * 97 + host) % 2**31)
        b_local = self.batch // n_hosts
        raw = rng.zipf(self.zipf_a, size=(b_local, self.seq + 1))
        tokens = (raw % (self.vocab - 1)).astype(np.int32) + 1
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:].copy()}


def lm_batch(cfg, shape, step: int = 0, seed: int = 0):
    """Concrete batch for one (arch, shape) cell (smoke/benchmark scale)."""
    stream = TokenStream(vocab=cfg.vocab, batch=shape.global_batch, seq=shape.seq_len, seed=seed)
    batch = stream.batch_at(step)
    if cfg.frontend == "vision":
        rng = np.random.RandomState(seed + 7)
        batch["patches"] = rng.standard_normal(
            (shape.global_batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        rng = np.random.RandomState(seed + 11)
        batch["frames"] = rng.standard_normal(
            (shape.global_batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


__all__ = ["DATASETS", "TokenStream", "lm_batch", "mf_factors",
           "paper_dataset", "paper_queries"]
