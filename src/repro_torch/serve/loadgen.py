"""Open-loop Zipfian load generator for the serve engine; port of
`repro.serve.loadgen` (framework-free apart from the engine it drives).

Request popularity is Zipfian (a small pool of hot prompts dominates, which
the engine's hot-query result cache turns into hits) and arrivals are an
open-loop Poisson process at a configured rate, optionally ramping up so a
run can drive the engine through its degradation ladder and its admission
shedding on purpose. Open loop: arrivals are scheduled on the wall clock,
independent of completions, so a slow engine grows its queue instead of
slowing the generator; only then are queue wait, deadline expiry, shedding
and tier occupancy meaningful.

  1. `generate(cfg, vocab)` draws a deterministic schedule from the seed
     with numpy, field for field the JAX package's: a pool of
     ``pool_size`` prompts (lengths uniform in ``prompt_lens``), and per
     request its wall-clock offset (exponential gaps at the, possibly
     ramping, rate), a Zipf(``zipf_s``) pool pick, a ``max_new_tokens``
     draw and a deadline draw from ``deadline_mix``.
  2. `run_load(engine, arrivals)` replays the schedule against a live
     `DecodeEngine`: it submits every arrival whose time has come, steps
     the engine otherwise, records the tier of each step, and returns the
     summary: p50/p99 request latency and queue wait, completed requests
     per second, the shed and expired shares, the per-tier step occupancy
     and the result cache's stats.

The replay runs in wall-clock time, so the summary's numbers are
measurements of the engine on its device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from .engine import DecodeEngine, Request

__all__ = ["LoadgenConfig", "Arrival", "generate", "run_load", "zipf_probs"]


@dataclasses.dataclass(frozen=True)
class LoadgenConfig:
    """Knobs of one load-generation run (all draws seeded)."""

    rate_qps: float = 50.0            # open-loop arrival rate, requests/s
    n_requests: int = 64
    zipf_s: float = 1.1               # pool-popularity exponent (>= 0;
                                      # 0 = uniform, larger = hotter head)
    pool_size: int = 32               # distinct prompts in the pool
    prompt_lens: Tuple[int, int] = (4, 12)      # inclusive uniform range
    max_new_tokens_choices: Tuple[int, ...] = (4, 8, 16)
    # (deadline_s | None, weight) pairs; None = no deadline. Weights are
    # normalized, so ((None, 3), (0.25, 1)) = 75% / 25%.
    deadline_mix: Tuple[Tuple[Optional[float], float], ...] = ((None, 1.0),)
    ramp: float = 1.0                 # final/initial rate ratio (> 1 ramps
                                      # the arrival rate up over the run)
    seed: int = 0

    def __post_init__(self):
        if self.rate_qps <= 0 or self.n_requests < 1 or self.pool_size < 1:
            raise ValueError("rate_qps, n_requests, pool_size must be "
                             "positive")
        if self.zipf_s < 0 or self.ramp <= 0:
            raise ValueError("zipf_s must be >= 0 and ramp > 0")
        lo, hi = self.prompt_lens
        if not 1 <= lo <= hi:
            raise ValueError(f"prompt_lens must satisfy 1 <= lo <= hi, "
                             f"got {self.prompt_lens}")
        if not self.max_new_tokens_choices or not self.deadline_mix:
            raise ValueError("max_new_tokens_choices and deadline_mix must "
                             "be non-empty")


@dataclasses.dataclass
class Arrival:
    """One scheduled request, annotated in place by `run_load`."""

    t: float                          # wall-clock offset from run start (s)
    pool_id: int                      # which pool prompt (Zipf rank order)
    prompt: np.ndarray
    max_new_tokens: int
    deadline_s: Optional[float]
    request: Optional[Request] = None  # None until submitted or if SHED
    shed: bool = False


def zipf_probs(pool_size: int, s: float) -> np.ndarray:
    """Normalized Zipf pmf over ranks 1..pool_size: p_i ∝ i^-s."""
    w = np.arange(1, pool_size + 1, dtype=np.float64) ** -float(s)
    return w / w.sum()


def generate(cfg: LoadgenConfig, vocab: int) -> List[Arrival]:
    """Draw the deterministic arrival schedule (see module docstring)."""
    rng = np.random.RandomState(cfg.seed)
    lo, hi = cfg.prompt_lens
    pool = [rng.randint(1, vocab, size=rng.randint(lo, hi + 1))
            .astype(np.int32) for _ in range(cfg.pool_size)]
    probs = zipf_probs(cfg.pool_size, cfg.zipf_s)
    dl_vals = [d for d, _ in cfg.deadline_mix]
    dl_w = np.asarray([w for _, w in cfg.deadline_mix], np.float64)
    dl_w = dl_w / dl_w.sum()
    arrivals: List[Arrival] = []
    t = 0.0
    n = cfg.n_requests
    for i in range(n):
        # linear rate ramp across the run; gap ~ Exp(rate_i)
        frac = i / max(n - 1, 1)
        rate = cfg.rate_qps * (1.0 + (cfg.ramp - 1.0) * frac)
        t += float(rng.exponential(1.0 / rate))
        pid = int(rng.choice(cfg.pool_size, p=probs))
        arrivals.append(Arrival(
            t=t, pool_id=pid, prompt=pool[pid],
            max_new_tokens=int(rng.choice(cfg.max_new_tokens_choices)),
            deadline_s=dl_vals[int(rng.choice(len(dl_vals), p=dl_w))]))
    return arrivals


def _pctl(xs: List[float], p: float) -> float:
    return float(np.percentile(np.asarray(xs), p)) if xs else 0.0


def run_load(engine: DecodeEngine, arrivals: List[Arrival], *,
             max_wall_s: float = 300.0) -> dict:
    """Replay ``arrivals`` open-loop against ``engine``; returns the
    summary dict (and annotates each Arrival with its Request / shed flag).

    The loop submits every due arrival, then steps the engine if it has
    work; between the last submit and the next arrival it sleeps in short
    slices instead of busy-spinning. ``max_wall_s`` is a hard safety stop
    for a wedged engine — a truncated run still summarizes what completed.
    """
    t0 = time.perf_counter()
    i, n = 0, len(arrivals)
    tier_steps: dict = {}
    while True:
        now = time.perf_counter() - t0
        while i < n and arrivals[i].t <= now:
            a = arrivals[i]
            req = engine.submit(a.prompt, max_new_tokens=a.max_new_tokens,
                                deadline_s=a.deadline_s)
            a.request, a.shed = req, req is None
            i += 1
        if engine.queue or engine.active.any():
            engine.step()
            tier_steps[engine.tier] = tier_steps.get(engine.tier, 0) + 1
        elif i < n:
            gap = arrivals[i].t - (time.perf_counter() - t0)
            if gap > 0:
                time.sleep(min(gap, 0.005))
        else:
            break
        if time.perf_counter() - t0 > max_wall_s:
            break
    wall_s = time.perf_counter() - t0
    return summarize(engine, arrivals, wall_s, tier_steps)


def summarize(engine: DecodeEngine, arrivals: List[Arrival], wall_s: float,
              tier_steps: dict) -> dict:
    """Aggregate one replay into the BENCH_serve-shaped summary record."""
    submitted = [a for a in arrivals if a.request is not None]
    completed = [a for a in submitted
                 if a.request.t_done > 0 and not a.request.expired]
    expired = [a for a in submitted if a.request.expired]
    shed = sum(a.shed for a in arrivals)
    lat = [a.request.t_done - a.request.t_submit for a in completed]
    wait = [a.request.t_admit - a.request.t_submit for a in submitted
            if a.request.t_admit > 0]
    total_steps = sum(tier_steps.values())
    n = len(arrivals)
    out = {
        "requests": n,
        "wall_s": wall_s,
        "completed": len(completed),
        "queries_per_s": len(completed) / wall_s if wall_s > 0 else 0.0,
        "decoded_tokens": int(sum(len(a.request.out_tokens) - 1
                                  for a in completed)),
        "latency_p50_s": _pctl(lat, 50), "latency_p99_s": _pctl(lat, 99),
        "queue_wait_p50_s": _pctl(wait, 50),
        "queue_wait_p99_s": _pctl(wait, 99),
        "shed_frac": shed / n,
        "expired_frac": len(expired) / n,
        "stepdowns": engine.stepdowns, "stepups": engine.stepups,
        "max_tier": max(tier_steps) if tier_steps else 0,
        "tier_occupancy": {str(t): c / total_steps
                           for t, c in sorted(tier_steps.items())}
        if total_steps else {},
        "final_state": engine.health()["state"],
    }
    if engine.qcache is not None:
        out["cache"] = engine.qcache.stats()
    return out
