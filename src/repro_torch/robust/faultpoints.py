"""Named, seeded fault points; copy of `repro.robust.faultpoints`.

Every failure path the durability layer must survive — a WAL append that
dies, a snapshot write that tears, a compaction rebuild that throws, a
decode step that explodes — is guarded by a *named* fault point:

    fault.at("wal.append")          # in production code: no-op unless armed

Tests (or an operator, via ``REPRO_FAULTS``) arm points deterministically:

    fault.arm("compaction.rebuild", times=2)      # fail the next 2 hits
    fault.arm("wal.append", p=0.5, seed=3)        # seeded coin per hit
    fault.arm("snapshot.write", after=1, times=1) # fail exactly the 2nd hit

so every failure path above is exercisable — and *reproducible* — in tests
without monkeypatching internals. The disarmed fast path is one empty-dict
check, so production code pays nothing.

``REPRO_FAULTS`` is parsed once at import:
``name:p[:after[:times]]`` entries joined by ``,`` — e.g.
``REPRO_FAULTS="wal.append:1:0:1,compaction.rebuild:0.5"``.

The set of valid names is the declared :data:`FAULT_POINTS` inventory,
the JAX package's (the port places ``compaction.rebuild`` and
``serve.decode``; the WAL and snapshot points wait for their modules);
arming an undeclared name raises, so a typo'd fault silently never firing
cannot happen.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np

from ..obs import metrics as _metrics

__all__ = ["FAULT_POINTS", "FaultInjected", "FaultInjector", "fault"]


# Declared inventory: name -> where it is threaded.
FAULT_POINTS: Dict[str, str] = {
    "wal.append": "WriteAheadLog.append, before any bytes hit the file "
                  "(a fired fault loses the op cleanly; the stream is "
                  "not mutated because logging is write-ahead)",
    "wal.torn": "WriteAheadLog.append, after writing HALF the record "
                "(simulates a crash mid-write: recovery must truncate "
                "the torn tail, not fail)",
    "snapshot.write": "Searcher.save's temp-dir phase, once per file "
                      "written (a fired fault leaves the previous "
                      "snapshot untouched)",
    "compaction.rebuild": "stream/compaction.rebuild_base entry (drives "
                          "the Compactor's retry/backoff ladder)",
    "serve.decode": "DecodeEngine.step, before the decode computation",
}


class FaultInjected(RuntimeError):
    """The exception a fired fault point raises (unless overridden)."""


class _Point:
    __slots__ = ("p", "after", "times", "seed", "exc", "hits", "fired", "rng")

    def __init__(self, p: float, after: int, times: Optional[int],
                 seed: int, exc: type):
        self.p = float(p)
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.seed = int(seed)
        self.exc = exc
        self.hits = 0
        self.fired = 0
        self.rng = np.random.RandomState(seed)

    def roll(self) -> bool:
        """One hit: returns True when the point fires this time."""
        self.hits += 1
        if self.hits <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.p < 1.0 and self.rng.random_sample() >= self.p:
            return False
        self.fired += 1
        return True


class FaultInjector:
    """Process-wide registry of armed fault points (thread-safe)."""

    def __init__(self, env: Optional[str] = None):
        self._lock = threading.Lock()
        self._points: Dict[str, _Point] = {}
        if env:
            for entry in env.split(","):
                entry = entry.strip()
                if not entry:
                    continue
                name, *rest = entry.split(":")
                p = float(rest[0]) if len(rest) > 0 else 1.0
                after = int(rest[1]) if len(rest) > 1 else 0
                times = int(rest[2]) if len(rest) > 2 else None
                self.arm(name, p=p, after=after, times=times)

    # -- arming ---------------------------------------------------------------
    def arm(self, name: str, *, p: float = 1.0, after: int = 0,
            times: Optional[int] = None, seed: int = 0,
            exc: type = FaultInjected) -> None:
        """Arm ``name``: fire with probability ``p`` per hit, skipping the
        first ``after`` hits, at most ``times`` total (None = unlimited).
        The per-point RNG is seeded, so a probabilistic fault schedule is
        bit-reproducible."""
        if name not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {name!r}; declared points: "
                f"{', '.join(sorted(FAULT_POINTS))}")
        with self._lock:
            self._points[name] = _Point(p, after, times, seed, exc)

    def disarm(self, name: Optional[str] = None) -> None:
        """Disarm one point, or every point (``name=None``)."""
        with self._lock:
            if name is None:
                self._points.clear()
            else:
                self._points.pop(name, None)

    def armed(self, name: str) -> bool:
        return name in self._points

    def counts(self, name: str) -> tuple:
        """(hits, fired) of an armed point; (0, 0) if not armed."""
        pt = self._points.get(name)
        return (pt.hits, pt.fired) if pt is not None else (0, 0)

    # -- hit sites ------------------------------------------------------------
    def fires(self, name: str) -> bool:
        """One hit of ``name``; True when it fires. Disarmed = one dict
        lookup on an (almost always) empty dict — effectively free."""
        if not self._points:
            return False
        pt = self._points.get(name)
        if pt is None:
            return False
        with self._lock:
            fired = pt.roll()
        if fired and _metrics.enabled():
            _metrics.counter("robust.faults_injected").inc()
        return fired

    def at(self, name: str) -> None:
        """One hit of ``name``; raises the point's exception when it fires."""
        if not self._points:
            return
        if self.fires(name):
            raise self._points[name].exc(f"injected fault at {name!r}")


# Module singleton every hit site uses; REPRO_FAULTS arms points at import.
fault = FaultInjector(os.environ.get("REPRO_FAULTS"))
