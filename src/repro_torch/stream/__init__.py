# Streaming ProMIPS: mutable index = immutable base segment + append-only
# delta segment + tombstones, with snapshot/epoch versioning and background
# compaction; port of `repro.stream`.
from .compaction import CompactionConfig, Compactor, rebuild_base
from .mutable import MutableProMIPS
from .segments import DeltaSegment, Snapshot, StreamStats

__all__ = [
    "CompactionConfig", "Compactor", "rebuild_base",
    "MutableProMIPS",
    "DeltaSegment", "Snapshot", "StreamStats",
]
