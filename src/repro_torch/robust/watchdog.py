"""EWMA latency watchdog; copy of `repro.robust.watchdog`.

The one step-latency monitor: a step slower than ``threshold ×`` the
running EWMA is a straggler event. The serve engine's degradation ladder
reads it (the JAX package's trainer shares it too) and mirrors the EWMA
into the declared ``serve.step_latency_ewma`` gauge every step.

Two call styles, same math:

    wd.start(); ...; slow = wd.stop()      # trainer's bracket style
    slow = wd.observe(dt)                  # serve engine feeds measured dt
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["EwmaWatchdog"]


@dataclass
class EwmaWatchdog:
    threshold: float = 2.5
    alpha: float = 0.2
    ewma: float = 0.0
    events: int = 0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Returns True if the bracketed step was a straggler."""
        return self.observe(time.perf_counter() - self._t0)

    def observe(self, dt: float) -> bool:
        """Feed one step latency; True if it was a straggler. The first
        sample seeds the EWMA and is never flagged."""
        if self.ewma == 0.0:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        if slow:
            self.events += 1
        return slow
