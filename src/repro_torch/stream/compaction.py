"""Compaction: fold the delta and the tombstones back into a fresh immutable
base; port of `repro.stream.compaction`.

The rebuild is the port's host numpy `core.index.build_index` over the
surviving rows in canonical (ascending global id) order, with the stream's
stored build kwargs and seed, so a compacted base is bit-identical to a cold
build over the same rows (and to the JAX package's compacted base).

`Compactor` runs the rebuild on a background thread, off the search path.
The thread does host work only: the new base's tensors are made later, by
the next `MutableProMIPS.snapshot()` on the caller's thread. The stream is
locked twice, at the freeze (copy out the survivors, open the op log) and at
the install (swap the base, reset the delta, replay the ops that arrived
while the rebuild ran); searches keep using the old snapshot meanwhile.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.index import ProMIPSIndex, build_index
from ..obs import metrics as _metrics
from ..robust.faultpoints import fault


@dataclass(frozen=True)
class CompactionConfig:
    """Trigger: compact once the churn fraction (delta watermark + base
    tombstones, over base size + delta watermark) exceeds ``threshold``.

    Failure policy: a failed background rebuild is retried up to
    ``max_retries`` times with exponential backoff (``backoff_s *
    backoff_mult**attempt``, plus seeded jitter up to ``jitter`` of the
    delay) before the error is latched for `join()`."""

    threshold: float = 0.3
    max_retries: int = 0
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    jitter: float = 0.25


def rebuild_base(gids: np.ndarray, rows: np.ndarray, build_kwargs: dict) -> ProMIPSIndex:
    """Fresh base over the surviving rows, ids stamped GLOBAL. Rows are put
    in ascending-gid order first, so two rebuilds over the same survivors
    (in any order) are bit-identical. The fault point
    ``compaction.rebuild`` fires here when armed."""
    fault.at("compaction.rebuild")
    order = np.argsort(gids, kind="stable")
    g = np.asarray(gids)[order]
    idx = build_index(np.ascontiguousarray(rows[order], np.float32), **build_kwargs)
    local = idx.arrays.ids
    global_ids = np.where(local >= 0, g[np.maximum(local, 0)], -1).astype(np.int32)
    return ProMIPSIndex(arrays=idx.arrays._replace(ids=global_ids),
                        meta=idx.meta, layout=idx.layout)


class Compactor:
    """Background-compaction driver for one `MutableProMIPS`."""

    def __init__(self, cfg: CompactionConfig = CompactionConfig()):
        self.cfg = cfg
        self._thread: Optional[threading.Thread] = None
        self._join_lock = threading.Lock()   # serializes concurrent joiners
        self.runs = 0
        self.failures = 0                    # rebuild attempts that raised
        self.retries = 0                     # failures that were retried
        self.error: Optional[BaseException] = None
        self.last_error: Optional[str] = None  # survives join()
        self.last_rebuild_s: Optional[float] = None  # host time of the last build

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def maybe_trigger(self, stream) -> bool:
        """Start a background rebuild if churn crossed the threshold. A
        latched failure disables the trigger until `join()` clears it."""
        if (self.in_flight or self.error is not None
                or stream.churn_fraction <= self.cfg.threshold):
            return False
        self.start(stream)
        return True

    def start(self, stream) -> None:
        if self.in_flight:
            raise RuntimeError("compaction already in flight")
        gids, rows = stream._freeze_for_compaction()
        if len(gids) == 0:
            # nothing survives to rebuild from: keep the tombstoned base
            # (every dead row is masked anyway) and close the op log
            stream._abandon_compaction()
            return
        self.error = None
        cfg = self.cfg
        # seeded off the build seed and the run count: reproducible, and two
        # replicas do not retry in lockstep
        jit = np.random.RandomState(
            (int(stream.build_kwargs.get("seed", 0)) + self.runs) & 0x7FFFFFFF)

        def run():
            for attempt in range(cfg.max_retries + 1):
                try:
                    t0 = time.perf_counter()
                    new_base = rebuild_base(gids, rows, stream.build_kwargs)
                    self.last_rebuild_s = time.perf_counter() - t0
                    stream._install_compacted(new_base)
                    self.runs += 1
                    return
                except Exception as e:  # noqa: BLE001 - latched for join()
                    self.failures += 1
                    self.last_error = f"{type(e).__name__}: {e}"
                    if _metrics.enabled():
                        _metrics.counter("stream.compaction_errors").inc()
                    if attempt < cfg.max_retries:
                        self.retries += 1
                        if _metrics.enabled():
                            _metrics.counter("stream.compaction_retries").inc()
                        delay = cfg.backoff_s * cfg.backoff_mult ** attempt
                        time.sleep(delay * (1.0 + cfg.jitter * jit.rand()))
                        continue
                    # the freeze only copied state and the logged ops were
                    # applied live, so abandoning loses nothing
                    self.error = e
                    stream._abandon_compaction()

        self._thread = threading.Thread(target=run, name="promips-compaction",
                                        daemon=True)
        self._thread.start()

    def status(self) -> dict:
        """Compaction health for `maintenance_status()` and the serve
        engine's `health()`: the latched error is shown, not cleared
        (`join()` clears it), and ``last_error`` stays after a successful
        retry."""
        return {"in_flight": self.in_flight, "runs": self.runs,
                "failures": self.failures, "retries": self.retries,
                "error_latched": self.error is not None,
                "last_error": self.last_error}

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the rebuild; raise its latched error (and clear it).
        Safe under concurrent callers."""
        with self._join_lock:
            t = self._thread
            if t is not None:
                t.join(timeout)
                if t.is_alive():
                    raise TimeoutError("compaction did not finish in time")
                self._thread = None
            if self.error is not None:
                err, self.error = self.error, None
                raise RuntimeError("background compaction failed") from err


__all__ = ["CompactionConfig", "Compactor", "rebuild_base"]
