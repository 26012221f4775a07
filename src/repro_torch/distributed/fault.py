"""Fault tolerance and straggler policy (host-side); copy of
`repro.distributed.fault`, framework-free.

- StragglerMonitor: EWMA of step latency; a step slower than
  ``threshold x`` the EWMA flags a straggler event. The implementation is
  `repro_torch.robust.EwmaWatchdog`, the one EWMA detector the serve
  engine's degradation ladder also uses; this name is the trainer-facing
  alias.
- restart_plan: on resume, the steps still to run from the restored step
  (the data position is the step index, so nothing is replayed or
  skipped).
- ElasticPolicy: the (data, model) mesh shape for the devices actually
  alive.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..robust.watchdog import EwmaWatchdog

StragglerMonitor = EwmaWatchdog


def restart_plan(restored_step: int, total_steps: int):
    """Steps still to run after a restore; data position == step index."""
    return range(restored_step, total_steps)


@dataclass(frozen=True)
class ElasticPolicy:
    """Choose a mesh shape for the devices actually alive."""
    model_parallel: int = 16

    def mesh_shape(self, n_devices: int):
        mp = self.model_parallel
        while mp > 1 and n_devices % mp:
            mp //= 2
        return (n_devices // mp, mp)  # (data, model)


__all__ = ["StragglerMonitor", "restart_plan", "ElasticPolicy"]
