"""Tuning strategy: budgeted coordinate descent with a parity gate; port of
`repro.tune.search`.

One knob at a time, in a fixed order (verification backend, dense_frac,
tile_cap, prefilter_eps, then the rebuild-requiring build knobs when
enabled), each candidate measured against the INCUMBENT config with the
interleaved median-of-adjacent-pairs protocol (`cutout.interleaved_ratio`)
and accepted only when it is faster by more than the noise margin.

Every candidate must first pass the PARITY GATE: its (ids, scores) on the
cutout workload must be bitwise identical to the hand-picked baseline's. A
candidate that changes results (a lossy ``prefilter_eps``, a truncating
``tile_cap``, a ``page_bytes`` that moves the block geometry, or, on the
card, ``verification="batched"`` when `mips_score` sums a score in another
order than `block_mips`) is recorded with ``status: "rejected_parity"`` and
never shipped, so a tuned cache changes where time goes and never what comes
back. The first call of a candidate doubles as its parity check; a second
warm call captures the fused driver's CUDA graphs before the timed pairs.

The descent is capped in measured seconds (``budget_s``): candidates left
when it runs out are recorded ``skipped_budget``. If nothing beats the
baseline, the entry ships the hand-picked values with the measured ratios in
its trace.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core.promips import ProMIPS
from ..core.search_common import next_pow2
from ..launch import roofline as rl
from . import cache as _cache
from . import cutout as _cutout
from . import space as _space

# accept a candidate only when the incumbent/candidate time ratio clears
# this margin; below it, wall-clock jitter wins coin flips
ACCEPT_MARGIN = 0.02


def _search_fn(pm: ProMIPS, queries, opts: dict, knobs: dict):
    """Zero-arg search closure for one (workload opts, tuned knobs) pair.
    Every tuned knob is passed EXPLICITLY (tile_cap's "no cap" is
    n_blocks), so the measurement never consults the cache being written."""
    tile_cap = knobs["tile_cap"]
    if tile_cap is None:
        tile_cap = pm.meta.n_blocks
    eps = knobs["prefilter_eps"] if opts.get("prefilter") else 1.0

    def call():
        return pm.search(
            queries, k=opts.get("k", 10), budget=opts.get("budget"),
            budget2=opts.get("budget2"),
            norm_adaptive=opts.get("norm_adaptive", False),
            cs_prune=opts.get("cs_prune", False),
            verification=knobs["verification"],
            prefilter=opts.get("prefilter", False), prefilter_eps=eps,
            dense_frac=knobs["dense_frac"], tile_cap=int(tile_cap))
    return call


def _result_parity(res_a, res_b) -> bool:
    ids_a, scores_a, _ = res_a
    ids_b, scores_b, _ = res_b
    return (np.array_equal(ids_a.cpu().numpy(), ids_b.cpu().numpy())
            and np.array_equal(scores_a.cpu().numpy(),
                               scores_b.cpu().numpy()))


def _candidate_roofline(pm: ProMIPS, queries, opts: dict, knobs: dict,
                        result, measured_s: float) -> dict:
    """Analytic least-work bound of the candidate's whole search
    (`launch.roofline`) next to its measured time: the frontend, the round-1
    prefilter when on, the verification of every (query, page) pair the
    search counted (``stats.pages``) with the round-1 union's pages read
    once, and the rescore. The backends compute the same function, so they
    share the bound; what differs is how close they come to it."""
    meta, arrays = pm.meta, pm.arrays
    b, d = queries.shape
    k = opts.get("k", 10)
    prefilter = bool(opts.get("prefilter")) and bool(meta.sk_subspaces)
    eps = knobs["prefilter_eps"] if prefilter else 1.0
    parts = [rl.select_frontend(b, d, meta.m, meta.n_groups, meta.n_subparts,
                                meta.n_blocks, arrays.block_sp_idx.shape[1])]
    if prefilter:
        m_sk, kcw, sub_d = arrays.sk_codebooks.shape
        parts.append(rl.prefilter_round1(b, d, meta.n_blocks, m_sk, kcw,
                                         sub_d, meta.page_rows))
    union = _cutout.round1_union(arrays, meta, queries, k=k,
                                 prefilter=prefilter, prefilter_eps=eps)
    if knobs["tile_cap"] is not None:
        union = min(union, int(knobs["tile_cap"]))
    pairs = int(result[2].pages.sum())
    parts.append(rl.block_mips(b, d, k, meta.page_rows, union, union, pairs))
    parts.append(rl.topk_rescore(b, k, d))
    cost = rl.add(*parts)
    return {"roofline_s": cost["roofline_s"], "bound": cost["bound"],
            "flops": cost["flops"], "bytes": cost["bytes"],
            "roofline_frac": cost["roofline_s"] / max(measured_s, 1e-12)}


def _tile_cap_candidates(pm: ProMIPS, queries, opts: dict) -> list:
    """Derived per point: the exact round-1 union (removes the pow2
    padding) and a 25%-headroom variant, when they undercut the bucketed
    tile the default rule would pick."""
    u1 = _cutout.round1_union(
        pm.arrays, pm.meta, queries, k=opts.get("k", 10),
        prefilter=opts.get("prefilter", False),
        prefilter_eps=opts.get("prefilter_eps", 1.0))
    if u1 == 0:
        return []
    default_tile = min(next_pow2(u1), pm.meta.n_blocks)
    cands = sorted({u1, min(-(-u1 * 5 // 4), pm.meta.n_blocks)})
    return [c for c in cands if c < default_tile]


def tune_point(x: np.ndarray, queries: np.ndarray, *, build_opts: dict,
               search_opts: dict, device="cuda", budget_s: float = 60.0,
               reps: int = 5, include_build: bool = False,
               stages: bool = True, roofline: bool = True,
               write: bool = False, path: Optional[str] = None,
               progress=None) -> dict:
    """Tune one ``(n, d)`` point on ``device``; returns the
    cache-entry-shaped record.

    ``build_opts`` go to `ProMIPS.build` (with ``device``); ``search_opts``
    fix the workload (k, budgets, norm_adaptive, cs_prune, prefilter,
    prefilter_eps): the statistical contract is never tuned, only the
    hardware knobs declared in `tune.space`. The baseline is the hand-picked
    config; the returned entry's ``runtime`` section is the coordinate-descent
    winner (the baseline when nothing beats it) and its ``trace`` carries
    every candidate's measured ratio, parity verdict and roofline fraction.
    ``write=True`` saves the entry through `cache.save_entry` under the
    device's key.
    """
    say = progress if progress is not None else (lambda *_: None)
    t_start = time.monotonic()
    n, d = int(x.shape[0]), int(x.shape[1])

    pm = ProMIPS.build(x, device=device, **build_opts)
    q = torch.as_tensor(np.atleast_2d(queries), dtype=torch.float32,
                        device=pm.device).contiguous()
    opts = dict(search_opts)
    baseline = dict(_space.HAND_PICKED["runtime"])
    baseline["prefilter_eps"] = float(opts.get("prefilter_eps", 1.0))

    best = dict(baseline)
    fn_best = _search_fn(pm, q, opts, best)
    ref = _cutout._block(fn_best())       # parity reference
    n_q = max(int(q.shape[0]), 1)
    t_base = _cutout.time_call(fn_best, reps=reps, warmup=1)
    trace: list = []

    def out_of_budget() -> bool:
        return time.monotonic() - t_start > budget_s

    def try_candidate(name: str, value, make_fn):
        """``make_fn()`` -> (the candidate's search closure, its index)."""
        rec = {"knob": name, "value": value, "incumbent": best.get(name)}
        if out_of_budget():
            rec["status"] = "skipped_budget"
            trace.append(rec)
            return None
        try:
            fn_c, pm_c = make_fn()
            res_c = _cutout._block(fn_c())    # doubles as the parity check
        except Exception as e:
            rec["status"] = f"error: {type(e).__name__}: {e}"
            trace.append(rec)
            return None
        if not _result_parity(ref, res_c):
            rec["status"] = "rejected_parity"
            trace.append(rec)
            say(f"  {name}={value!r}: rejected (changes results)")
            return None
        _cutout._block(fn_c())                # captures the fused graphs
        t_inc, t_cand, ratio = _cutout.interleaved_ratio(fn_best, fn_c, reps)
        rec.update(incumbent_us_per_query=t_inc * 1e6 / n_q,
                   candidate_us_per_query=t_cand * 1e6 / n_q,
                   ratio_incumbent_over_candidate=ratio)
        if roofline:
            rec.update(_candidate_roofline(pm_c, q, opts,
                                           {**best, name: value}, res_c,
                                           t_cand))
        accepted = ratio > 1.0 + ACCEPT_MARGIN
        rec["status"] = "accepted" if accepted else "rejected_slower"
        trace.append(rec)
        say(f"  {name}={value!r}: x{ratio:.3f} "
            f"({'accepted' if accepted else 'kept incumbent'})")
        return fn_c if accepted else None

    # -- coordinate descent over the runtime knobs --------------------------
    say(f"tuning ({n}, {d}) runtime knobs on {pm.device}, budget "
        f"{budget_s:.0f}s")
    for name in ("verification", "dense_frac", "tile_cap", "prefilter_eps"):
        if name == "prefilter_eps" and not opts.get("prefilter"):
            continue
        if (name in ("dense_frac", "tile_cap")
                and best["verification"] != "fused"):
            # fused-only tile knobs: measuring them against a non-fused
            # incumbent would accept pure wall-clock noise
            trace.append({"knob": name, "status": "skipped_not_fused"})
            continue
        if name == "tile_cap":
            cands = _tile_cap_candidates(pm, q, opts)
        else:
            cands = [c for c in _space.knob(name).candidates
                     if c != best[name]]
        for value in cands:
            won = try_candidate(
                name, value,
                lambda v=value: (_search_fn(pm, q, opts, {**best, name: v}),
                                 pm))
            if won is not None:
                best[name] = value
                fn_best = won

    # -- build knobs (rebuild per candidate; smoke/CLI only by default) -----
    build_best = dict(_space.HAND_PICKED["build"])
    if "page_bytes" in build_opts:
        build_best["page_bytes"] = int(build_opts["page_bytes"])
    if include_build:
        for name in ("page_bytes", "max_probe_groups"):
            for value in [c for c in _space.knob(name).candidates
                          if c != build_best[name]]:
                def rebuild(v=value, knob_name=name):
                    pm2 = ProMIPS.build(x, device=device,
                                        **{**build_opts, knob_name: v})
                    return _search_fn(pm2, q, opts, best), pm2
                won = try_candidate(name, value, rebuild)
                if won is not None:
                    build_best[name] = value
                    fn_best = won
    else:
        trace.append({"knob": "build", "status": "skipped_disabled",
                      "note": "rebuild-per-candidate tuning off "
                              "(include_build=False)"})

    t_best = _cutout.time_call(fn_best, reps=reps, warmup=0)
    summary = {
        "n": n, "d": d, "n_blocks": int(pm.meta.n_blocks),
        "device": str(pm.device),
        "baseline": baseline, "workload": opts,
        "baseline_us_per_query": t_base * 1e6 / n_q,
        "best_us_per_query": t_best * 1e6 / n_q,
        "speedup_tuned_vs_default": t_base / max(t_best, 1e-12),
        "budget_s": budget_s, "elapsed_s": time.monotonic() - t_start,
        "n_candidates": sum(1 for r in trace if "knob" in r
                            and "ratio_incumbent_over_candidate" in r),
    }
    entry_trace = {"summary": summary, "candidates": trace}
    if stages:
        tc = best["tile_cap"]
        entry_trace["stages_best"] = _cutout.stage_records(
            pm.arrays, pm.meta, q, k=opts.get("k", 10),
            prefilter=opts.get("prefilter", False),
            prefilter_eps=(best["prefilter_eps"] if opts.get("prefilter")
                           else 1.0),
            dense_frac=best["dense_frac"],
            tile_cap=int(tc) if tc is not None else None, reps=reps)
    say(f"tuned ({n}, {d}): x{summary['speedup_tuned_vs_default']:.3f} "
        f"vs hand-picked in {summary['elapsed_s']:.1f}s "
        f"({summary['n_candidates']} candidates measured)")

    entry = {"runtime": best, "build": build_best, "trace": entry_trace}
    if write:
        entry["key"] = _cache.save_entry(
            n, d, device=pm.device, runtime=best, build=build_best,
            trace=entry_trace, path=path)
    return entry


__all__ = ["tune_point", "ACCEPT_MARGIN"]
