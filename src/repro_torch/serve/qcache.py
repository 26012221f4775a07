"""LRU hot-query result cache for the decode-time c-AMIP search; copy of
`repro.serve.qcache` (framework-free, the same fingerprint).

Recsys / multi-class-prediction traffic (the paper's §I use cases) is
Zipfian: a small set of hot queries dominates. A repeated prompt drives the
decode loop through bit-identical hidden states, so the two-phase search it
triggers is pure recomputation — ScaNN-style serving systems win exactly
this workload with a result cache in front of the index. `HotQueryCache`
memoizes `(ids, scores)` rows of the decode search keyed on a QUANTIZED
fingerprint of the hidden state:

  fingerprint = float16(h).tobytes()

float16 is the quantizer: bit-identical hidden rows always collide (the hot
path), while the 10-bit mantissa absorbs sub-quantum numeric wobble without
aliasing genuinely different queries — two hiddens that differ anywhere by
more than one f16 ulp get distinct keys. A hit therefore returns the result
of a query whose hidden state matches to f16 precision; on COLD traffic
(all misses) the cache is bit-invisible, which is the correctness contract
the engine tests pin (cache-on == cache-off token streams).

Entries are invalidated wholesale on any index mutation (`clear()` from
engine.update()/delete()): a cached row may name a tombstoned id or miss a
fresher delta row, and the engine's correctness story ("retired vocab ids
are never decoded again") must survive the cache. The engine also keys
entries by degradation tier, so a result computed at full budget is never
replayed as evidence of a degraded tier's quality (and vice versa).

Counters (hits/misses/evictions) are kept locally and mirrored into the
`serve.cache_*` metrics by the engine when ``obs=True``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Hashable, Optional, Tuple

import numpy as np

__all__ = ["HotQueryCache"]


class HotQueryCache:
    """Bounded LRU mapping fingerprint -> (ids, scores) result rows.

    capacity <= 0 builds a permanently-empty cache (every get() misses,
    put() is a no-op) so callers can keep one unconditional code path.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._entries: "OrderedDict[Hashable, Tuple[np.ndarray, np.ndarray]]" \
            = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def fingerprint(row: np.ndarray) -> bytes:
        """Quantized key of one hidden-state row (see module docstring)."""
        return np.ascontiguousarray(row, np.float16).tobytes()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: Hashable) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        hit = self._entries.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return hit

    def put(self, key: Hashable, ids: np.ndarray, scores: np.ndarray) -> None:
        if self.capacity <= 0:
            return
        # defensive copies: the engine reuses/overwrites result buffers
        self._entries[key] = (np.array(ids, np.int64),
                              np.array(scores, np.float32))
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        """Drop every entry (index mutated); counters are preserved —
        invalidation is not an eviction."""
        self._entries.clear()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"size": len(self._entries), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate}
