"""Cutout runner: isolate and time one search stage at a target point; port
of `repro.tune.cutout`.

The tuner never times a stage inside the full pipeline: each stage is cut
out and driven alone on deterministic synthetic data matching the target
``(n, d)`` point (`make_cutout`, the `mf_factors` family of every benchmark
corpus), and two arms are compared with the interleaved
median-of-adjacent-pairs protocol (`interleaved_ratio`): candidate and
incumbent alternate within one session, and the ratio is the median over
adjacent pairs, so a noise spike inflates one pair instead of a whole arm.
Every timed call is fenced: on the card by `torch.cuda.synchronize` of
each device its result lives on (the counterpart of
`jax.block_until_ready`), so a time covers the device work.

`stage_records` reports, per stage, the measured time next to the analytic
least-work count of `launch.roofline` (``static_upper_bound: False``) and
their ratio ``roofline_frac``: the share of the card's bound the stage
reaches. On the CPU the fraction is only a normalization (the constants are
the H100's).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core import runtime as _runtime
from ..core import search_device as sd
from ..core import search_fused as sf
from ..core.index import IndexArrays, IndexMeta
from ..data.synthetic import mf_factors
from ..launch import roofline as rl


def make_cutout(n: int, d: int, n_q: int = 64, *, rank: int = 16,
                decay: float = 0.5, norm_tail: float = 0.6, seed: int = 0):
    """Deterministic synthetic (corpus, queries) for one tuning point: the
    MF-factor family (and, at the default kwargs, the seeds 0/1 convention)
    of the benchmark corpora, so a LARGE_N cutout is the LARGE_N workload.
    The same arguments give the JAX package's arrays bit for bit."""
    x = mf_factors(n, d, rank, decay=decay, seed=seed, norm_tail=norm_tail)
    q = mf_factors(n_q, d, rank, decay=decay, seed=seed + 1)
    return x, q


def _tensors(v):
    if isinstance(v, torch.Tensor):
        yield v
    elif isinstance(v, (tuple, list)):
        for item in v:
            yield from _tensors(item)


def _block(v):
    """Wait for every CUDA device that holds a tensor of ``v``."""
    for dev in {t.device for t in _tensors(v) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return v


def time_call(fn, *args, reps: int = 5, warmup: int = 1) -> float:
    """Median wall-clock seconds of ``fn(*args)`` over ``reps`` fenced
    calls (after ``warmup`` calls that build, capture or warm caches)."""
    for _ in range(max(warmup, 0)):
        _block(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def interleaved_ratio(fn_a, fn_b, reps: int = 5):
    """(median_t_a, median_t_b, median per-pair t_a/t_b) over ``reps``
    interleaved A/B pairs. Callers warm both arms before measuring."""
    ta, tb, ratios = [], [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(fn_a())
        t1 = time.perf_counter()
        _block(fn_b())
        t2 = time.perf_counter()
        ta.append(t1 - t0)
        tb.append(t2 - t1)
        ratios.append((t1 - t0) / max(t2 - t1, 1e-12))
    return (float(np.median(ta)), float(np.median(tb)),
            float(np.median(ratios)))


def _queries(arrays: IndexArrays, queries) -> torch.Tensor:
    return torch.as_tensor(queries, dtype=torch.float32,
                           device=arrays.x.device).contiguous()


def round1_masks(arrays: IndexArrays, meta: IndexMeta, queries, *,
                 k: int = 10, prefilter: bool = False,
                 prefilter_eps: float = 1.0,
                 use_kernels: Optional[bool] = None):
    """(frontend outputs, round-1 (B, NB) mask after the optional
    prefilter): the selection the round-1 tile is planned from."""
    q = _queries(arrays, queries)
    front = sd.select_frontend(arrays, meta, q, use_kernels)
    mask_r1 = front[6]
    if prefilter and meta.sk_subspaces:
        mask_r1 = sd.prefilter_round1(arrays, q, front[6], k, meta.page_rows,
                                      prefilter_eps, use_kernels)[0]
    return front, mask_r1


def round1_union(arrays: IndexArrays, meta: IndexMeta, queries, *,
                 k: int = 10, prefilter: bool = False,
                 prefilter_eps: float = 1.0,
                 use_kernels: Optional[bool] = None) -> int:
    """Number of distinct blocks the round-1 batch union selects: what the
    tile-cap candidates key off (an exact-fit cap removes the next_pow2
    padding without truncating anything)."""
    _, mask_r1 = round1_masks(arrays, meta, queries, k=k,
                              prefilter=prefilter,
                              prefilter_eps=prefilter_eps,
                              use_kernels=use_kernels)
    return int(mask_r1.any(dim=0).sum())


def stage_records(arrays: IndexArrays, meta: IndexMeta, queries, *,
                  k: int = 10, prefilter: bool = False,
                  prefilter_eps: float = 1.0, dense_frac: float = 0.9,
                  tile_cap: Optional[int] = None,
                  use_kernels: Optional[bool] = None, reps: int = 5) -> dict:
    """Isolated per-stage times at one point, against the analytic bound.
    Stages mirror the host fused driver: `select_frontend`, the optional
    sketch prefilter, one fused verification tile planned by
    `search_fused._plan_tile`, and the exact rescore. Returns {stage: {us,
    us_per_query, flops, bytes, t_compute_s, t_memory_s, roofline_s, bound,
    static_upper_bound, roofline_frac}} plus a ``_tile`` record of the
    planned round-1 tile (union, slots, dense)."""
    q = _queries(arrays, queries)
    n_batch, d = q.shape
    recs: dict = {}

    def rec(name, count, fn, *args):
        us = time_call(fn, *args, reps=reps) * 1e6
        entry = {"us": us, "us_per_query": us / max(n_batch, 1)}
        entry.update(count)
        entry["roofline_frac"] = entry["roofline_s"] / max(us * 1e-6, 1e-12)
        recs[name] = entry

    rec("select_frontend",
        rl.select_frontend(n_batch, d, meta.m, meta.n_groups,
                           meta.n_subparts, meta.n_blocks,
                           arrays.block_sp_idx.shape[1]),
        sd.select_frontend, arrays, meta, q, use_kernels)
    front = sd.select_frontend(arrays, meta, q, use_kernels)
    c_half, mask0 = front[5], front[6]
    mask_r1 = mask0
    if prefilter and meta.sk_subspaces:
        m_sk, kcw, sub_d = arrays.sk_codebooks.shape
        rec("prefilter_round1",
            rl.prefilter_round1(n_batch, d, meta.n_blocks, m_sk, kcw, sub_d,
                                meta.page_rows),
            sd.prefilter_round1, arrays, q, mask0, k, meta.page_rows,
            prefilter_eps, use_kernels)
        mask_r1 = sd.prefilter_round1(arrays, q, mask0, k, meta.page_rows,
                                      prefilter_eps, use_kernels)[0]

    cap = meta.n_blocks if tile_cap is None else min(int(tile_cap),
                                                     meta.n_blocks)
    mask_np = mask_r1.cpu().numpy()
    plan = sf._plan_tile(mask_np, cap, meta.n_blocks, dense_frac)
    dev = q.device
    top = sd.TopK(scores=torch.full((n_batch, k), float("-inf"), device=dev),
                  rows=torch.full((n_batch, k), -1, dtype=torch.int32,
                                  device=dev))
    if plan is not None:
        slots_np, sel_np, _, dense = plan
        recs["_tile"] = {"n_union": int(mask_np.any(0).sum()),
                         "tile_slots": int(len(slots_np)),
                         "dense": bool(dense)}
        valid = arrays.ids >= 0
        slots = torch.from_numpy(slots_np).to(dev)
        sel = torch.from_numpy(np.ascontiguousarray(sel_np)).to(dev)
        args = (arrays, valid, q, slots, sel, top, c_half, k, meta.page_rows,
                dense, use_kernels)
        rec("fused_verify_tile",
            rl.fused_verify_tile(n_batch, d, k, meta.page_rows, len(slots_np),
                                 int(sel_np.any(axis=0).sum()),
                                 int(sel_np.sum())),
            sf._verify, *args)
        top = sf._verify(*args)[0]
    rec("topk_rescore", rl.topk_rescore(n_batch, k, d), _runtime._rescore,
        arrays.x, top.rows, q)
    return recs


__all__ = ["make_cutout", "time_call", "interleaved_ratio", "round1_masks",
           "round1_union", "stage_records"]
