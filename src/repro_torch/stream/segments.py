"""Segment primitives of the mutable ProMIPS index; port of
`repro.stream.segments`.

A streaming index is (base segment, delta segment, tombstones):

  base   - one immutable `core.index` build product; the tombstone bitmap
           addresses its padded sorted layout.
  delta  - an append-only buffer of raw rows: preallocated host arrays and
           a fill watermark (``count``). Delta rows are scored exactly at
           search time by `kernels.ops.mips_score`.
  tombstones - "alive" bitmaps over both segments; a deleted row stays until
           compaction and is masked to -inf when results are merged.

`Snapshot` freezes one (base, delta watermark, tombstone epoch) triple as
tensors on the stream's device. Writers never write into a published
snapshot's tensors: each snapshot holds its own copies of the bitmap and the
delta prefix, and the base tensors are never written at all.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from ..core.index import IndexArrays, IndexMeta
from ..core.search_device import SearchStats


class StreamStats(NamedTuple):
    """Per-query stats of a segment-merged search."""

    pages: object           # logical pages: base two-phase + delta sweep
    candidates: object      # verified rows: base candidates + live delta rows
    exhausted: object       # base budget exhausted (the delta is always exact)
    base: SearchStats       # the base two-phase search's own stats

    def to_dict(self) -> dict:
        """Normalized accounting (`core.stats.stats_totals`)."""
        from ..core.stats import stats_totals
        return stats_totals(self.pages, self.candidates, self.exhausted)


class DeltaSegment:
    """Append-only row buffer: preallocated host arrays + fill watermark.

    Slots [0, count) are filled; `alive` marks which still count (a
    deleted or updated delta row is tombstoned in place, and compaction
    reclaims it).
    """

    def __init__(self, capacity: int, d: int):
        self.capacity = int(capacity)
        self.d = int(d)
        self.x = np.zeros((self.capacity, d), np.float32)
        self.gids = np.full(self.capacity, -1, np.int64)
        self.alive = np.zeros(self.capacity, bool)
        self.count = 0  # fill watermark

    @property
    def n_alive(self) -> int:
        return int(self.alive[: self.count].sum())

    def append(self, gids: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Bulk append; returns the slots written. The caller checks room."""
        n = len(gids)
        if self.count + n > self.capacity:
            raise ValueError(
                f"delta segment full: {self.count}+{n} > {self.capacity} "
                "(compact first or grow delta_capacity)")
        slots = np.arange(self.count, self.count + n)
        self.x[slots] = rows
        self.gids[slots] = gids
        self.alive[slots] = True
        self.count += n
        return slots

    def survivors(self):
        """(gids, rows) of the live delta entries, in append order."""
        live = np.nonzero(self.alive[: self.count])[0]
        return self.gids[live], self.x[live]


@dataclass(frozen=True)
class Snapshot:
    """One consistent view of the mutable index, as tensors on one device.

    Searches against a snapshot keep answering for its epoch while writers
    append, tombstone or compact."""

    arrays: IndexArrays      # base segment tensors, ids already GLOBAL
    meta: IndexMeta
    base_alive: object       # (n_pad,) bool - False = tombstoned/padding
    delta_x: object          # (cap_q, d) f32 - a pow2 prefix of the buffer
    delta_gids: object       # (cap_q,) int32 - -1 for unfilled slots
    delta_valid: object      # (cap_q,) bool - below the watermark AND alive
    epoch: int               # write epoch this snapshot froze
    delta_count: int         # fill watermark at freeze time
    n_base_dead: int         # base tombstones at freeze time (over-fetch k)
    clean: bool = field(default=False)  # no tombstones, empty delta


__all__ = ["DeltaSegment", "Snapshot", "StreamStats"]
