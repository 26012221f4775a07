"""Process-wide metrics registry; copy of `repro.obs.metrics` (framework-free).

Three instrument kinds behind one lock:

  Counter    monotonic float/int accumulator (`inc(n)`)
  Gauge      last-written value (`set(v)`)
  Histogram  log2-bucketed distribution (`observe(v)`): bucket ``i`` counts
             observations with ``2^(i-1) < v <= 2^i`` (``i=0`` holds
             ``v <= 1``), plus exact ``count`` / ``sum`` — enough for
             p50/p99-style questions at a fixed 2x resolution with O(64)
             storage and no per-observation allocation.

**Every name must be declared** in `GLOSSARY` below (name -> (kind, help)):
`counter()/gauge()/histogram()` raise ``ValueError`` on an undeclared name
or a kind mismatch, so an instrumented path can never silently invent a
metric — scripts/ci.sh's obs tier relies on this to fail loudly.

Instruments are created lazily on first use; `snapshot()` returns only the
instruments that exist, so a snapshot taken after a smoke search shows
exactly which paths actually recorded. Feeds:

  * `core/stats.stats_totals` — the single choke point every stats class's
    `to_dict()` goes through — calls `observe_search(totals)` when the
    registry is ENABLED (`enable()`); one bool check when disabled.
  * The streaming index feeds the ``stream.*`` counters when enabled.
  * The serve engine's ``obs=True`` writes the ``serve.*`` instruments
    directly (already gated by its own flag).

The glossary keeps every name the JAX package declares, the span
histograms of `obs.trace` included, so that both packages accept the same
names.

`register_collector(fn)` adds a callback run at every `snapshot()` /
`prometheus_text()` — used for pull-style values (e.g. the fused driver's
retrace total) that would otherwise need a hook on every mutation.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Callable, Dict

__all__ = ["GLOSSARY", "Counter", "Gauge", "Histogram", "counter", "gauge",
           "histogram", "snapshot", "reset", "enable", "disable", "enabled",
           "observe_search", "register_collector", "flush_jsonl",
           "prometheus_text"]

# --------------------------------------------------------------------------
# Declared metric-name glossary: name -> (kind, help).
# --------------------------------------------------------------------------
GLOSSARY: Dict[str, tuple] = {
    # stats choke point (core/stats.stats_totals, all four stats classes)
    "search.queries": ("counter", "queries accounted through stats_totals"),
    "search.pages": ("counter", "logical 4KB pages touched (paper's axis)"),
    "search.candidates": ("counter", "rows scored by verification"),
    "search.exhausted": ("counter", "queries that hit a budget cap"),
    # per-phase span timings (host-orchestrated fused driver + runtime)
    "search.batch_us": ("histogram", "end-to-end search() batch wall µs"),
    "search.frontend_us": ("histogram", "select_frontend span µs"),
    "search.compensation_us": ("histogram", "Condition-B mask span µs"),
    "search.prefilter_us": ("histogram", "sketch prefilter round span µs"),
    "search.plan_us": ("histogram", "host tile planning span µs (includes "
                                    "the mask device->host pull)"),
    "search.verify_round_us": ("histogram", "one fused verify round µs"),
    "search.rescore_us": ("histogram", "shared top-k rescore span µs"),
    "search.merge_us": ("histogram", "stream segment merge span µs"),
    "search.prefilter_survivor_frac": ("gauge",
                                       "blocks surviving the sketch "
                                       "prefilter / blocks selected"),
    # fused driver round shape + jit-cache health
    "fused.rounds_dense": ("counter", "verify rounds on the dense path"),
    "fused.rounds_sparse": ("counter", "verify rounds on the gathered tile"),
    "fused.rounds_skipped": ("counter", "rounds skipped (empty union)"),
    "fused.rounds_cached": ("counter", "rounds served from the dense "
                                       "score cache (no new matmul)"),
    "fused.verify_retraces": ("gauge", "total verify-jit retraces ever "
                                       "(bounded ring's monotonic count)"),
    # sharded fan-out
    "sharded.fanout_us": ("histogram", "in-graph shard_map fan-out µs"),
    "sharded.dispatch_us": ("histogram", "host-merge per-shard dispatch µs "
                                         "(enqueue only: NOT fenced, shard "
                                         "searches overlap by design)"),
    "sharded.merge_us": ("histogram", "host k x shards merge µs (includes "
                                      "pulling per-shard results)"),
    # streaming index
    "stream.delta_appends": ("counter", "rows appended to delta segments"),
    "stream.deletes": ("counter", "rows tombstoned"),
    "stream.compactions": ("counter", "compactions installed (sync + bg)"),
    "stream.compaction_us": ("histogram", "synchronous compact() span µs"),
    # durability + fault handling (DESIGN.md §16)
    "stream.compaction_errors": ("counter", "background rebuild attempts "
                                            "that raised"),
    "stream.compaction_retries": ("counter", "failed rebuilds retried with "
                                             "backoff"),
    "stream.wal_appends": ("counter", "records appended to the WAL"),
    "stream.wal_bytes": ("counter", "bytes appended to the WAL"),
    "robust.faults_injected": ("counter", "armed fault points that fired"),
    # serve engine (DecodeEngine obs=True)
    "serve.requests_submitted": ("counter", "requests accepted by submit()"),
    "serve.requests_completed": ("counter", "requests finished (EOS/len)"),
    "serve.requests_shed": ("counter", "requests rejected: queue full"),
    "serve.tombstones": ("counter", "vocab ids retired via delete()"),
    "serve.decode_steps": ("counter", "engine decode steps"),
    "serve.pages": ("counter", "index pages touched by decode searches"),
    "serve.queue_wait_us": ("histogram", "submit -> slot admission µs"),
    # hot-query result cache (serve/qcache.py, DESIGN.md §17)
    "serve.cache_hits": ("counter", "decode searches served from the "
                                    "hot-query result cache"),
    "serve.cache_misses": ("counter", "decode searches that went to the "
                                      "index (cache cold/absent rows)"),
    "serve.cache_evictions": ("counter", "LRU evictions from the hot-query "
                                         "result cache"),
    "serve.request_us": ("histogram", "submit -> completion µs"),
    "serve.step_us": ("histogram", "one engine step µs"),
    "serve.slot_occupancy": ("gauge", "active slots / batch slots"),
    "serve.queue_depth": ("gauge", "queued requests after last step"),
    # serve degradation ladder (DESIGN.md §16)
    "serve.degradation_tier": ("gauge", "current budget tier (0 = full "
                                        "quality, higher = cheaper)"),
    "serve.tier_stepdowns": ("counter", "ladder transitions to a cheaper "
                                        "tier under overload"),
    "serve.tier_stepups": ("counter", "ladder recoveries to a richer tier"),
    "serve.deadline_expired": ("counter", "requests dropped past their "
                                          "deadline"),
    "serve.step_latency_ewma": ("gauge", "EWMA of engine step seconds "
                                         "(the shared robust watchdog)"),
}

_lock = threading.Lock()
_registry: Dict[str, object] = {}
_collectors: list = []
_enabled = False


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1) -> None:
        with _lock:
            self.value += n


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v) -> None:
        with _lock:
            self.value = float(v)


class Histogram:
    """log2 buckets: index i counts v in (2^(i-1), 2^i]; i=0 counts v<=1."""

    __slots__ = ("name", "count", "sum", "buckets")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.buckets: Dict[int, int] = {}

    @staticmethod
    def bucket_of(v: float) -> int:
        if v <= 1.0:
            return 0
        return int(math.ceil(math.log2(v)))

    def observe(self, v) -> None:
        v = float(v)
        b = self.bucket_of(v)
        with _lock:
            self.count += 1
            self.sum += v
            self.buckets[b] = self.buckets.get(b, 0) + 1

    def to_dict(self) -> dict:
        with _lock:
            return {"count": self.count, "sum": self.sum,
                    "mean": self.sum / self.count if self.count else 0.0,
                    "buckets": {str(k): v
                                for k, v in sorted(self.buckets.items())}}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _get(name: str, kind: str):
    decl = GLOSSARY.get(name)
    if decl is None:
        raise ValueError(
            f"undeclared metric name {name!r}: every metric must be listed "
            "in repro_torch.obs.metrics.GLOSSARY")
    if decl[0] != kind:
        raise ValueError(f"metric {name!r} is declared as a {decl[0]}, "
                         f"requested as a {kind}")
    inst = _registry.get(name)
    if inst is None:
        with _lock:
            inst = _registry.get(name)
            if inst is None:
                inst = _KINDS[kind](name)
                _registry[name] = inst
    return inst


def counter(name: str) -> Counter:
    return _get(name, "counter")


def gauge(name: str) -> Gauge:
    return _get(name, "gauge")


def histogram(name: str) -> Histogram:
    return _get(name, "histogram")


def enable() -> None:
    """Turn on the ambient feeds (the stats_totals choke point)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop every instrument (collectors stay registered)."""
    with _lock:
        _registry.clear()


def register_collector(fn: Callable[[], None]) -> None:
    with _lock:
        _collectors.append(fn)


def observe_search(totals: dict) -> None:
    """The `core/stats.stats_totals` choke-point feed. No-op (one bool
    check) unless `enable()` was called — the disabled path stays free."""
    if not _enabled:
        return
    counter("search.queries").inc(int(totals.get("queries", 0)))
    counter("search.pages").inc(int(totals.get("pages", 0)))
    counter("search.candidates").inc(int(totals.get("candidates", 0)))
    counter("search.exhausted").inc(int(totals.get("exhausted", 0)))


def snapshot() -> dict:
    """One plain dict of every live instrument: counters/gauges -> number,
    histograms -> {count, sum, mean, buckets}. Runs collectors first."""
    for fn in list(_collectors):
        fn()
    with _lock:
        items = list(_registry.items())
    out = {}
    for name, inst in items:
        out[name] = (inst.to_dict() if isinstance(inst, Histogram)
                     else inst.value)
    return out


def flush_jsonl(path: str, extra: dict = None) -> None:
    """Append one `snapshot()` line (plus ``extra`` fields) to ``path``."""
    import os
    rec = dict(extra or {})
    rec["metrics"] = snapshot()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def _prom_name(name: str) -> str:
    return "repro_" + name.replace(".", "_")


def prometheus_text() -> str:
    """Prometheus text exposition (0.0.4): counters/gauges verbatim,
    histograms as cumulative ``_bucket{le=...}`` + ``_sum``/``_count``
    with le = 2^i upper bounds matching the log2 buckets."""
    for fn in list(_collectors):
        fn()
    with _lock:
        items = sorted(_registry.items())
    lines = []
    for name, inst in items:
        kind, help_text = GLOSSARY[name]
        pname = _prom_name(name)
        lines.append(f"# HELP {pname} {help_text}")
        if isinstance(inst, Histogram):
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for b, cnt in sorted(inst.buckets.items()):
                cum += cnt
                lines.append(f'{pname}_bucket{{le="{float(2 ** b)}"}} {cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {inst.count}')
            lines.append(f"{pname}_sum {inst.sum}")
            lines.append(f"{pname}_count {inst.count}")
        else:
            lines.append(f"# TYPE {pname} "
                         f"{'counter' if kind == 'counter' else 'gauge'}")
            lines.append(f"{pname} {inst.value}")
    return "\n".join(lines) + "\n"
