"""Span tracer, ``with span("select_frontend"): ...``; port of
`repro.obs.trace`.

1. **Disabled cost about one function call.** `span()` returns a shared
   no-op context manager when tracing is off (and the caller did not force
   ``active=True``): an instrumented path pays one global read, one branch
   and an empty ``with``.

2. **Honest timings need fencing.** CUDA work is queued asynchronously: a
   span around it without a fence measures the enqueue, and the device
   time shows up in whichever later span first waits for a value (a copy
   to the host, a sync). `sp.fence(x)` synchronizes the current stream of
   every CUDA device that holds a tensor of ``x``, *only when fencing is
   configured on* (`enable(fence=True)`); CPU tensors are ready when their
   op returns. Spans record whether they were fenced (the ``fenced`` flag,
   also in the Chrome trace's args).

3. **Bounded storage, thread-safe.** Completed spans land in a ring buffer
   (default 8192) under a lock; `total()` counts every span ever recorded.

`export_chrome_trace(path)` writes ``{"traceEvents": [...]}`` JSON
(``ph="X"`` complete events, µs timestamps) that chrome://tracing and
Perfetto load. With ``annotate=True`` each span also enters
`torch.profiler.record_function`, so spans line up with the kernels in a
`torch.profiler` trace.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import torch

__all__ = ["span", "configure", "enable", "disable", "enabled", "fencing",
           "spans", "clear", "total", "export_chrome_trace"]

_lock = threading.Lock()
_enabled = False
_fence = False
_annotate = False
_capacity = 8192
_ring: list = []          # completed span dicts, append order, bounded
_total = 0                # every span ever recorded (monotonic)

_EPOCH_NS = time.perf_counter_ns()   # trace timestamps are relative to import


def configure(enabled: Optional[bool] = None, fence: Optional[bool] = None,
              annotate: Optional[bool] = None,
              capacity: Optional[int] = None) -> None:
    """Set any subset of the tracer's four knobs (None = leave unchanged)."""
    global _enabled, _fence, _annotate, _capacity
    with _lock:
        if enabled is not None:
            _enabled = bool(enabled)
        if fence is not None:
            _fence = bool(fence)
        if annotate is not None:
            _annotate = bool(annotate)
        if capacity is not None:
            if int(capacity) < 1:
                raise ValueError(f"capacity must be >= 1, got {capacity!r}")
            _capacity = int(capacity)
            del _ring[: max(0, len(_ring) - _capacity)]


def enable(fence: bool = False, annotate: bool = False) -> None:
    configure(enabled=True, fence=fence, annotate=annotate)


def disable() -> None:
    configure(enabled=False, fence=False, annotate=False)


def enabled() -> bool:
    return _enabled


def fencing() -> bool:
    return _fence


def clear() -> None:
    """Drop stored spans (does not reset `total()`: it is monotonic)."""
    with _lock:
        _ring.clear()


def total() -> int:
    return _total


def spans() -> list:
    """Completed spans (oldest first) as dicts
    ``{name, t0_us, dur_us, tid, fenced}``; a copy, safe to iterate while
    other threads trace."""
    with _lock:
        return list(_ring)


def _record(rec: dict) -> None:
    global _total
    with _lock:
        _total += 1
        _ring.append(rec)
        if len(_ring) > _capacity:
            del _ring[: len(_ring) - _capacity]


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in ``x`` (nested tuples, lists and
    dicts, NamedTuples included)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    return out


class _NullSpan:
    """Shared no-op span: the whole disabled-path cost."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, x):
        return x


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "metric", "_t0", "_fenced", "_ann")

    def __init__(self, name: str, metric: Optional[str]):
        self.name = name
        self.metric = metric
        self._fenced = False
        self._ann = None

    def __enter__(self):
        if _annotate:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def fence(self, x):
        """Wait for ``x`` (a tensor or a nest of them) iff fencing is on.
        Returns ``x`` either way, so call sites read naturally."""
        if _fence and x is not None:
            for dev in _cuda_devices(x, set()):
                torch.cuda.current_stream(dev).synchronize()
            self._fenced = True
        return x

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        dur_us = (t1 - self._t0) / 1e3
        _record({"name": self.name,
                 "t0_us": (self._t0 - _EPOCH_NS) / 1e3,
                 "dur_us": dur_us,
                 "tid": threading.get_ident(),
                 "fenced": self._fenced})
        if self.metric is not None:
            from . import metrics
            metrics.histogram(self.metric).observe(dur_us)
        return False


def span(name: str, active: Optional[bool] = None,
         metric: Optional[str] = None):
    """Open a span. ``active=None`` follows the global switch; True forces
    recording for this call (the `RuntimeConfig.obs` per-call opt-in),
    False forces the no-op. ``metric`` names a declared histogram of
    `obs.metrics`, fed the span's duration in µs."""
    if not (_enabled if active is None else active):
        return _NULL
    return _Span(name, metric)


def export_chrome_trace(path: str) -> str:
    """Write the stored spans as Chrome trace-event JSON (Perfetto loads
    it) and return ``path``: one ``ph="X"`` complete event per span, whose
    ``args`` carry the ``fenced`` flag so enqueue-time spans can be told
    from fenced ones."""
    recs = spans()
    tids = {}
    events = []
    for r in recs:
        tid = tids.setdefault(r["tid"], len(tids))
        events.append({"name": r["name"], "ph": "X", "pid": 0, "tid": tid,
                       "ts": r["t0_us"], "dur": r["dur_us"],
                       "cat": "repro_torch.obs",
                       "args": {"fenced": r["fenced"]}})
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"exporter": "repro_torch.obs.trace",
                         "span_count": len(events)}}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path
