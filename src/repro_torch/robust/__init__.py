"""Crash-safe durability and fault injection; port of `repro.robust`.

  wal.py          CRC32-checksummed, length-prefixed write-ahead log over
                  the mutable index's insert/delete/update/compaction ops;
                  `recover()` = last good snapshot + replay, bit-identical
                  to the uncrashed stream.
  snapshot.py     manifest'd (per-file SHA256 + provenance) atomic snapshot
                  directories; `CorruptSnapshotError` fail-fast on load.
  faultpoints.py  named, seeded fault points (`fault.at("wal.append")`)
                  threaded through every durability-critical path so each
                  failure mode is deterministic in tests.
  watchdog.py     the one EWMA step-latency monitor (the serve engine's
                  degradation ladder and the trainer's straggler policy).
"""
from .faultpoints import FAULT_POINTS, FaultInjected, FaultInjector, fault
from .snapshot import CorruptSnapshotError, verify_dir, write_atomic_dir
from .wal import (WAL_MAGIC, WalConfig, WalCorruptError, WalRecord,
                  WriteAheadLog, read_records, recover, replay_into)
from .watchdog import EwmaWatchdog

__all__ = [
    "FAULT_POINTS", "FaultInjected", "FaultInjector", "fault",
    "CorruptSnapshotError", "verify_dir", "write_atomic_dir",
    "WAL_MAGIC", "WalConfig", "WalCorruptError", "WalRecord",
    "WriteAheadLog", "read_records", "recover", "replay_into",
    "EwmaWatchdog",
]
