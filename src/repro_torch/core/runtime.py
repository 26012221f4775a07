"""Two-phase search runtime; port of `repro.core.runtime` for the fused and
batched verification backends and the streaming index.

`search` validates a `RuntimeConfig`, clamps the budgets to the index,
runs `search_fused.search_batch_fused` (``verification="fused"``) or
`search_device._search_batch_batched` (``"batched"``, the serve engine's
default) and rescores the k winners exactly (`_rescore`).
`search_segments` runs it over a streaming snapshot's base with an
over-fetched k and merges in the delta segment's exact scores
(`_merge_segments`). Both run on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels import ops, ref
from ..tune import cache as tune_cache
from .index import IndexArrays, IndexMeta, resolve_device
from .search_common import DENSE_FRAC, next_pow2
from .search_device import SearchStats, _search_batch_batched
from .search_fused import search_batch_fused


def _rescore(x, rows, queries):
    """Exact f32 inner products of the returned candidate rows: (B, k),
    -inf where the row is -1."""
    cand = x[torch.clamp(rows, min=0).long()]                  # (B, k, d)
    s = torch.einsum("bkd,bd->bk", cand, queries)
    return torch.where(rows >= 0, s, torch.full_like(s, float("-inf")))


VALID_MODES = ("two_phase", "progressive")
VALID_VERIFICATIONS = ("fused", "batched", "scan")


@dataclass(frozen=True)
class RuntimeConfig:
    """Search configuration, validated at construction and at `search`.

    ``use_kernels``: None runs the CUDA kernels on CUDA tensors and the plain
    versions on CPU tensors; False asks for the plain versions on the card;
    True on the CPU raises. ``dense_frac`` and ``tile_cap`` None consult
    the tuning cache for the index's shape on the search's device and fall
    back to `DENSE_FRAC` and no cap (`tune.cache.resolved`), as the JAX
    package's `search` does.
    ``obs=True`` (per-call spans) raises until `obs/trace.py` is ported.
    """

    k: int = 10
    budget: Optional[int] = None       # None => all blocks (no truncation)
    budget2: Optional[int] = None      # compensation round; None => budget
    mode: str = "two_phase"
    verification: str = "fused"
    norm_adaptive: bool = False
    cs_prune: bool = False
    use_kernels: Optional[bool] = None
    prefilter: bool = False            # quantized-sketch block prefilter
    prefilter_eps: float = 1.0         # sketch-bound scale; 1.0 = lossless
    dense_frac: Optional[float] = None  # dense-tile threshold
    tile_cap: Optional[int] = None      # extra clamp on both rounds' tiles
    obs: bool = False                   # per-call span instrumentation

    def __post_init__(self):
        for field_name in ("prefilter_eps", "dense_frac"):
            v = getattr(self, field_name)
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
                object.__setattr__(self, field_name, float(v))
        self.validate()

    def validate(self) -> None:
        if self.mode not in VALID_MODES:
            raise ValueError(f"unknown search mode: {self.mode!r}; valid "
                             f"choices: {', '.join(VALID_MODES)}")
        if self.verification not in VALID_VERIFICATIONS:
            raise ValueError(
                f"unknown verification backend: {self.verification!r}; valid "
                f"choices: {', '.join(VALID_VERIFICATIONS)}")
        if self.mode == "progressive":
            raise NotImplementedError(
                "mode='progressive' is not ported yet (ROADMAP Queue 1 item 5)")
        if self.verification == "scan":
            raise NotImplementedError(
                "verification='scan' is not ported yet (ROADMAP Queue 1 "
                "item 5)")
        if not isinstance(self.k, (int, np.integer)) or self.k < 1:
            raise ValueError(f"k must be a positive int, got {self.k!r}")
        for field_name in ("budget", "budget2"):
            v = getattr(self, field_name)
            if v is not None and (not isinstance(v, (int, np.integer)) or v < 1):
                raise ValueError(f"{field_name} must be None (= all blocks) "
                                 f"or a positive int, got {v!r}")
        for field_name in ("prefilter", "norm_adaptive", "cs_prune", "obs"):
            if not isinstance(getattr(self, field_name), bool):
                raise ValueError(f"{field_name} must be a bool, got "
                                 f"{getattr(self, field_name)!r}")
        if self.obs:
            raise NotImplementedError(
                "obs=True needs the span tracer, which is not ported yet "
                "(ROADMAP Queue 1 item 8)")
        if self.use_kernels is not None and not isinstance(self.use_kernels, bool):
            raise ValueError(f"use_kernels must be None or a bool, got "
                             f"{self.use_kernels!r}")
        eps = self.prefilter_eps
        if not isinstance(eps, (int, float, np.floating)) or isinstance(
                eps, bool) or not 0.0 < float(eps) <= 1.0:
            raise ValueError(f"prefilter_eps must be a float in (0, 1], got "
                             f"{eps!r}")
        df = self.dense_frac
        if df is not None and (
                not isinstance(df, (int, float, np.floating))
                or isinstance(df, bool) or not 0.0 < float(df) <= 1.0):
            raise ValueError(f"dense_frac must be None (= default) or a float "
                             f"in (0, 1], got {df!r}")
        tc = self.tile_cap
        if tc is not None and (not isinstance(tc, (int, np.integer))
                               or isinstance(tc, bool) or tc < 1):
            raise ValueError(f"tile_cap must be None or a positive int, got "
                             f"{tc!r}")


def _queries(queries, meta: IndexMeta, dev) -> torch.Tensor:
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    q = torch.atleast_2d(q).contiguous()
    if q.dim() != 2 or q.shape[1] != meta.d:
        raise ValueError(f"queries must be (B, {meta.d}), got {tuple(q.shape)}")
    return q


def search(arrays: IndexArrays, meta: IndexMeta, queries,
           cfg: RuntimeConfig = RuntimeConfig(), *, device="cuda"):
    """Run one batched c-k-AMIP search under ``cfg`` on ``device``.

    ``arrays`` must already live on ``device`` (`index.to_device`);
    queries: (B, d) or (d,), array-like or tensor. Returns (ids (B, k),
    scores (B, k), SearchStats).
    """
    cfg.validate()
    dev = resolve_device(device)
    if arrays.x.device != dev:
        raise ValueError(f"index arrays are on {arrays.x.device}, search asked "
                         f"for {dev}")
    if cfg.prefilter and not meta.sk_subspaces:
        raise ValueError("prefilter=True but the index carries no sketch")
    budget = int(min(cfg.budget if cfg.budget is not None else meta.n_blocks,
                     meta.n_blocks))
    budget2 = int(min(cfg.budget2 if cfg.budget2 is not None else budget,
                      meta.n_blocks))
    # the tuned fused-tile knobs: explicit values win; None consults the
    # tuning cache for this index's shape key on this device, the
    # hand-picked defaults on a miss
    dense_frac, tile_cap = cfg.dense_frac, cfg.tile_cap
    if cfg.mode == "two_phase" and cfg.verification == "fused" and (
            dense_frac is None or tile_cap is None):
        tuned = tune_cache.resolved("runtime", meta.n, meta.d, device=dev)
        if dense_frac is None:
            dense_frac = float(tuned.get("dense_frac", DENSE_FRAC))
        if tile_cap is None:
            tc = tuned.get("tile_cap")
            tile_cap = int(tc) if tc is not None else None
    elif dense_frac is None:
        dense_frac = DENSE_FRAC
    q = _queries(queries, meta, dev)
    if cfg.verification == "batched":
        ids, _, stats = _search_batch_batched(
            arrays, meta, q, cfg.k, budget, budget2, cfg.norm_adaptive,
            cfg.cs_prune, cfg.use_kernels, cfg.prefilter, cfg.prefilter_eps)
    else:
        ids, _, stats = search_batch_fused(
            arrays, meta, q, k=cfg.k, budget=budget, budget2=budget2,
            norm_adaptive=cfg.norm_adaptive, cs_prune=cfg.cs_prune,
            use_kernels=cfg.use_kernels, prefilter=cfg.prefilter,
            prefilter_eps=cfg.prefilter_eps, dense_frac=dense_frac,
            tile_cap=tile_cap)
    scores = _rescore(arrays.x, stats.rows, q)
    return ids, scores, stats


# ---------------------------------------------------------------------------
# Segment-aware entry (streaming index)
# ---------------------------------------------------------------------------

def _merge_segments(base_alive, rows, base_ids, base_scores, delta_x,
                    delta_gids, delta_valid, queries, k: int, use_kernels):
    """Merge the base top-k_base with the exact-scored delta segment.

    ``base_scores`` are the `_rescore`d inner products `search` returned;
    tombstoned base rows go to -inf. Every delta row is scored in one
    `ops.mips_score` call (invalid rows to -inf after it). One stable top-k
    over the concatenation keeps `lax.top_k`'s rule: a tie goes to the
    lower index, so base entries first."""
    alive = (rows >= 0) & base_alive[torch.clamp(rows, min=0).long()]
    neg_inf = torch.tensor(float("-inf"), device=base_scores.device)
    b_scores = torch.where(alive, base_scores, neg_inf)
    b_ids = torch.where(alive, base_ids, torch.full_like(base_ids, -1))
    d_scores = ops.mips_score(delta_x, queries, delta_valid,
                              use_kernels=use_kernels).T       # (B, cap)
    d_scores = torch.where(delta_valid[None, :], d_scores, neg_inf)
    d_ids = torch.where(delta_valid, delta_gids,
                        torch.full_like(delta_gids, -1)).expand_as(d_scores)
    merged_s = torch.cat([b_scores, d_scores], dim=1)
    merged_i = torch.cat([b_ids.int(), d_ids], dim=1)
    best_s, pos = ref.topk_stable(merged_s, k)
    return merged_i.gather(1, pos), best_s


def search_segments(snap, queries, cfg: RuntimeConfig = RuntimeConfig(), *,
                    device="cuda"):
    """Batched c-k-AMIP search over a streaming `stream.segments.Snapshot`
    whose tensors live on ``device``.

    The base search over-fetches ``k + next_pow2(n_base_dead)`` results
    (clamped to n_pad) so tombstoned rows cannot crowd live ones out of the
    top-k, then the delta's exact scores are merged in. A ``clean`` snapshot
    (no tombstones, empty delta) is `search` on the base unchanged.

    Returns (global ids (B, k), scores (B, k), StreamStats).
    """
    from ..stream.segments import StreamStats  # stream imports this module

    cfg.validate()
    dev = resolve_device(device)
    meta = snap.meta
    q = _queries(queries, meta, dev)
    if snap.clean:
        ids, scores, stats = search(snap.arrays, meta, q, cfg, device=dev)
        return ids, scores, StreamStats(pages=stats.pages,
                                        candidates=stats.candidates,
                                        exhausted=stats.exhausted, base=stats)
    k_base = min(cfg.k + (next_pow2(snap.n_base_dead) if snap.n_base_dead
                          else 0), meta.n_pad)
    ids_b, scores_b, stats = search(snap.arrays, meta, q,
                                    dataclasses.replace(cfg, k=k_base),
                                    device=dev)
    ids, scores = _merge_segments(snap.base_alive, stats.rows, ids_b,
                                  scores_b, snap.delta_x, snap.delta_gids,
                                  snap.delta_valid, q, cfg.k, cfg.use_kernels)
    delta_pages = -(-snap.delta_count // meta.page_rows)  # logical delta sweep
    return ids, scores, StreamStats(
        pages=stats.pages + delta_pages,
        candidates=stats.candidates + snap.delta_valid.sum(dtype=torch.int32),
        exhausted=stats.exhausted,
        base=stats,
    )


__all__ = ["RuntimeConfig", "SearchStats", "next_pow2", "search",
           "search_segments"]
