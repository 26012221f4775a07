"""Declared parameter space of the autotuner; port of `repro.tune.space`.

Every hardware knob the search runtime and the serve engine expose (as
opposed to the statistical knobs the paper derives: m*, x_p, the Theorem-2
budgets) is declared here once, with its legal range, the hand-picked
default, and the section of a tuning-cache entry it lands in:

  runtime   per-search `RuntimeConfig` knobs (no rebuild needed)
  build     `api.build` / `build_index` knobs (changing one rebuilds)
  serve     `serve.engine.DecodeEngine` knobs

Cache entries are keyed by `shape_key(n, d, device)`: the pow2 n-bucket,
exact d, the device (``cuda-<device name>`` or ``cpu``) and the torch
version (`tune.cache` reads and writes them; `tune.search` measures them).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Tuple

import torch


def n_bucket(n: int) -> int:
    """pow2 bucketing of the corpus size (same quantizer as the fused tile
    shapes): a tuned entry covers every n in (bucket/2, bucket]."""
    return 1 << max(0, int(n) - 1).bit_length()


def shape_key(n: int, d: int, device) -> str:
    """Cache key for one tuning point on ``device``: the platform part is
    ``cuda-<device name>`` for a CUDA device and ``cpu`` for the CPU, then
    ``torch<version>``, which keeps it apart from every JAX key (those end
    in ``jax<version>``). A cache tuned on another card or torch build
    never matches and falls back to the hand-picked defaults."""
    return (f"n{n_bucket(n)}:d{int(d)}:{platform(device)}"
            f":torch{torch.__version__}")


def platform(device) -> str:
    """The platform part of a key: ``cuda-<device name>`` for a CUDA
    device, the device type otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _platform(device)


@functools.lru_cache(maxsize=None)
def _platform(device: torch.device) -> str:
    return (f"cuda-{torch.cuda.get_device_name(device)}"
            if device.type == "cuda" else device.type)


@dataclass(frozen=True)
class Knob:
    """One tunable knob: its cache section, hand-picked default, and the
    candidate values the coordinate-descent search tries (a () candidates
    tuple means the candidates are derived per point at tune time, e.g.
    ``tile_cap`` from the observed union sizes)."""

    name: str
    section: str                 # "runtime" | "build" | "serve"
    default: Any
    candidates: Tuple[Any, ...]
    description: str


KNOBS: Tuple[Knob, ...] = (
    Knob("verification", "runtime", "fused", ("fused", "batched"),
         "candidate-scoring backend (bit-identical results at every budget)"),
    Knob("dense_frac", "runtime", 0.9, (0.5, 0.7, 0.8, 0.9, 1.0),
         "union fraction above which the fused tile is every block in place "
         "(dense and sparse tiles are result-bit-identical)"),
    Knob("tile_cap", "runtime", None, (),
         "extra clamp on both fused rounds' tile sizes below the budget "
         "rule; candidates derived from the observed union sizes (an exact-"
         "fit cap removes the next_pow2 padding)"),
    Knob("prefilter_eps", "runtime", 1.0, (0.05, 0.08, 0.1, 0.15, 0.2),
         "quantized-sketch bound scale; 1.0 is lossless, smaller prunes "
         "harder (only tuned when the workload runs with prefilter=True)"),
    Knob("page_bytes", "build", 4096, (2048, 4096, 8192),
         "block page size -> page_rows geometry (requires rebuild)"),
    Knob("max_probe_groups", "build", None, (256, 512, 1024),
         "cap on the Quick-Probe group table (None = all distinct sign "
         "codes; dropping groups is conservative — the probe still returns "
         "a valid point — but weakens r0; requires rebuild)"),
    Knob("decode_batch_slots", "serve", 4, (2, 4, 8),
         "serve-engine decode batch slots (continuous-batching width)"),
    Knob("result_cache_size", "serve", 256, (0, 64, 256, 1024),
         "LRU hot-query result-cache capacity for the decode search "
         "(serve/qcache.py; 0 disables — cold traffic is bit-identical "
         "either way, so the knob only trades memory for Zipfian hit rate)"),
    Knob("max_refill_per_step", "serve", None, (1, 2, 4),
         "cap on requests admitted per engine step (None = refill every "
         "free slot; lower bounds the per-step prefill burst at the cost "
         "of queue wait)"),
)

# The hand-picked defaults, by cache section (`tune.cache.resolved` overlays
# a tuned entry on this dict).
HAND_PICKED = {
    "runtime": {"verification": "fused", "dense_frac": 0.9, "tile_cap": None,
                "prefilter_eps": 1.0},
    "build": {"page_bytes": 4096, "max_probe_groups": None},
    "serve": {"decode_batch_slots": 4, "result_cache_size": 256,
              "max_refill_per_step": None},
}


def knob(name: str) -> Knob:
    for k in KNOBS:
        if k.name == name:
            return k
    raise KeyError(f"unknown knob: {name!r}")


__all__ = ["Knob", "KNOBS", "HAND_PICKED", "knob", "n_bucket", "platform",
           "shape_key"]
