"""Fault injection and the step-latency watchdog of the port (copies of
`repro.robust.faultpoints` and `repro.robust.watchdog`). The write-ahead
log and checksummed snapshots are not ported yet (ROADMAP Queue 1 item 8).
"""
from .faultpoints import FAULT_POINTS, FaultInjected, FaultInjector, fault
from .watchdog import EwmaWatchdog

__all__ = ["FAULT_POINTS", "FaultInjected", "FaultInjector", "fault",
           "EwmaWatchdog"]
