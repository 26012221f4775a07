"""MutableProMIPS: a ProMIPS index that absorbs inserts, updates and
deletes; port of `repro.stream.mutable`.

One immutable BASE segment (a `build_index` product with GLOBAL ids), an
append-only DELTA segment of raw rows scored exactly at search time, and
tombstone bitmaps over both. Searches run against an epoch-versioned
`Snapshot` whose tensors live on the stream's device; writers change host
state under a lock and bump the epoch, so a search never sees a write half
applied. Past a churn fraction, compaction rebuilds the base on the host
(seeded, deterministic) and swaps it in.

>>> st = MutableProMIPS(x, m=8, seed=0)          # device="cuda" by default
>>> st.insert(new_ids, new_rows)        # exact-scored from the next search
>>> st.delete(stale_ids)                # masked to -inf from the next search
>>> ids, scores, stats = st.search(queries, k=10)
>>> st.compact()                        # fold delta + tombstones into the base

The write-ahead-log hooks (`attach_wal`, `_wal_append`, ...) are kept so that
the state and the op order match the JAX package's; they do nothing while
no log is attached.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from ..core.index import (IndexArrays, IndexMeta, ProMIPSIndex, resolve_device,
                          to_device)
from ..core.runtime import RuntimeConfig, next_pow2, search_segments
from ..obs import metrics as _metrics
from .compaction import CompactionConfig, Compactor, rebuild_base
from .segments import DeltaSegment, Snapshot


class MutableProMIPS:
    """Mutable index = base segment + delta segment + tombstones."""

    def __init__(self, x: np.ndarray, ids: Optional[np.ndarray] = None, *,
                 delta_capacity: Optional[int] = None,
                 compaction: CompactionConfig = CompactionConfig(),
                 auto_compact: bool = False, device="cuda",
                 **build_kwargs):
        """``build_kwargs`` go to `core.index.build_index` as they are (m, c,
        p, page_bytes, seed, ...) and are reused by every compaction; the
        seed defaults to 0. Snapshots live on ``device``."""
        self.device = resolve_device(device)   # fail before the host build
        x = np.ascontiguousarray(x, np.float32)
        n, d = x.shape
        gids = (np.arange(n, dtype=np.int64) if ids is None
                else np.asarray(ids, np.int64))
        self._check_gids(gids)
        build_kwargs.setdefault("seed", 0)
        self.build_kwargs = dict(build_kwargs)
        self.d = d
        self._lock = threading.RLock()
        self._oplog: Optional[list] = None   # open while a rebuild is in flight
        self._defer_trigger = False          # True inside update()'s two halves
        self._init_wal_state()
        self._delta_capacity = (int(delta_capacity) if delta_capacity
                                else max(64, n // 2))
        self._set_base(rebuild_base(gids, x, self.build_kwargs))
        self._reset_delta()
        self._epoch = 0
        self._snap: Optional[Snapshot] = None
        self._next_id = int(gids.max()) + 1 if n else 0
        self.compactor = Compactor(compaction) if auto_compact else None

    # -- state plumbing ------------------------------------------------------
    def _set_base(self, base: ProMIPSIndex) -> None:
        self._base = base
        self._base_dev = None                     # tensors made in snapshot()
        self._base_alive = base.arrays.ids >= 0   # (n_pad,) - padding is dead
        self._n_base_dead = 0
        self._row_of = {int(g): r for r, g in enumerate(base.arrays.ids) if g >= 0}

    def _reset_delta(self) -> None:
        self._delta = DeltaSegment(self._delta_capacity, self.d)
        self._slot_of: dict[int, int] = {}

    @property
    def meta(self) -> IndexMeta:
        return self._base.meta

    @property
    def n_alive(self) -> int:
        return (self.meta.n - self._n_base_dead) + self._delta.n_alive

    @property
    def delta_capacity(self) -> int:
        return self._delta.capacity

    @property
    def delta_fraction(self) -> float:
        """Live delta rows over live rows: what a search pays extra."""
        return self._delta.n_alive / max(1, self.n_alive)

    @property
    def churn_fraction(self) -> float:
        """Absorbed writes over base size, the compaction trigger (counts
        tombstoned delta slots too: only compaction reclaims them)."""
        return ((self._delta.count + self._n_base_dead)
                / max(1, self.meta.n + self._delta.count))

    def alive_items(self) -> tuple[np.ndarray, np.ndarray]:
        """(gids, rows) of every live row: base survivors, then the live
        delta entries in append order."""
        with self._lock:
            live = np.nonzero(self._base_alive)[0]
            bg = self._base.arrays.ids[live].astype(np.int64)
            bx = self._base.arrays.x[live]
            dg, dx = self._delta.survivors()
            return np.concatenate([bg, dg]), np.concatenate([bx, dx])

    def _is_alive(self, gid: int) -> bool:
        slot = self._slot_of.get(gid)
        if slot is not None and self._delta.alive[slot]:
            return True
        row = self._row_of.get(gid)
        return row is not None and bool(self._base_alive[row])

    def _log(self, op) -> None:
        if self._oplog is not None:
            self._oplog.append(op)

    def _dirty(self) -> None:
        self._epoch += 1
        self._snap = None
        if (self.compactor is not None and self._oplog is None
                and not self._defer_trigger and not self._wal_replaying):
            self.compactor.maybe_trigger(self)

    # -- durability hooks (no-ops while no log is attached) ------------------
    def _init_wal_state(self) -> None:
        self._wal = None             # attached write-ahead log, if any
        self._wal_seq = 0            # seq of the last record logged
        self._wal_floor = 0          # seq baked into the last snapshot
        self._wal_suspended = False  # True while replaying the compaction op log
        self._wal_replaying = False  # True during crash-recovery replay

    def attach_wal(self, wal) -> None:
        """Bind a write-ahead log (an object with ``append(seq, op, gids,
        rows)``); every later mutation is logged before it is applied."""
        with self._lock:
            self._wal = wal

    def wal_lag(self) -> int:
        """Records logged since the state this stream was restored from."""
        with self._lock:
            return self._wal_seq - self._wal_floor if self._wal is not None else 0

    def mark_wal_floor(self) -> None:
        with self._lock:
            self._wal_floor = self._wal_seq

    def _wal_append(self, op: str, gids=None, rows=None) -> None:
        # the seq moves only after a successful append, so a failed write
        # rejects the op without burning a sequence number
        if (self._wal is None or self._wal_suspended
                or self._wal_replaying):
            return
        self._wal.append(self._wal_seq + 1, op, gids, rows)
        self._wal_seq += 1

    # -- writes --------------------------------------------------------------
    @staticmethod
    def _check_gids(gids: np.ndarray) -> None:
        if len(np.unique(gids)) != len(gids):
            raise ValueError("duplicate ids within one call")
        if len(gids) and (gids.min() < 0 or gids.max() >= 2 ** 31):
            raise ValueError("ids must fit int32 (device ids are int32)")

    def insert(self, ids, rows, _wait_ok: bool = True) -> None:
        """Append new rows; the ids must not be alive (`update` replaces).

        If the delta is full while a background rebuild is in flight, the
        writer waits for the install (outside the lock) and retries.
        ``_wait_ok=False`` (inside update()'s lock, where waiting would
        deadlock against the install) raises instead."""
        gids = np.atleast_1d(np.asarray(ids, np.int64))
        rows = np.atleast_2d(np.asarray(rows, np.float32))
        self._check_gids(gids)
        if rows.shape != (len(gids), self.d):
            raise ValueError(f"rows must be ({len(gids)}, {self.d}), "
                             f"got {rows.shape}")
        if len(gids) > self._delta.capacity:
            raise ValueError(f"batch of {len(gids)} rows exceeds delta "
                             f"capacity {self._delta.capacity}")
        retried = False
        while True:
            with self._lock:
                for g in gids:
                    if self._is_alive(int(g)):
                        raise ValueError(f"id {int(g)} already alive; use update()")
                full = self._delta.count + len(gids) > self._delta.capacity
                if not full or self._oplog is None:
                    if full:
                        self.compact()
                    # logged after any self-compaction and before the append
                    self._wal_append("insert", gids, rows)
                    slots = self._delta.append(gids, rows)
                    for g, s in zip(gids, slots):
                        self._slot_of[int(g)] = int(s)
                    self._next_id = max(self._next_id, int(gids.max()) + 1)
                    self._log(("insert", gids.copy(), rows.copy()))
                    self._dirty()
                    if _metrics.enabled():
                        _metrics.counter("stream.delta_appends").inc(len(gids))
                    return
            if not _wait_ok or self.compactor is None:
                raise RuntimeError("delta full while compaction in flight")
            if self.compactor.in_flight:
                self.compactor.join()   # install/abandon closes the op log
            elif retried:
                raise RuntimeError("delta full while compaction in flight")
            retried = True

    def add(self, rows) -> np.ndarray:
        """Insert rows under freshly assigned ids; returns them."""
        rows = np.atleast_2d(np.asarray(rows, np.float32))
        if (self.compactor is not None and self.compactor.in_flight
                and self._delta.count + len(rows) > self._delta.capacity):
            self.compactor.join()  # outside the lock, as in update()
        with self._lock:
            gids = np.arange(self._next_id, self._next_id + len(rows), dtype=np.int64)
            self.insert(gids, rows, _wait_ok=False)
        return gids

    def delete(self, ids) -> None:
        """Tombstone rows (reclaimed at compaction). Every id is checked
        first, so a bad call changes nothing."""
        gids = np.atleast_1d(np.asarray(ids, np.int64))
        self._check_gids(gids)
        with self._lock:
            for g in gids:
                if not self._is_alive(int(g)):
                    raise KeyError(f"id {int(g)} is not alive")
            self._wal_append("delete", gids)
            for g in gids:
                g = int(g)
                slot = self._slot_of.get(g)
                if slot is not None and self._delta.alive[slot]:
                    self._delta.alive[slot] = False
                    del self._slot_of[g]
                else:
                    self._base_alive[self._row_of[g]] = False
                    self._n_base_dead += 1
            self._log(("delete", gids.copy()))
            self._dirty()
            if _metrics.enabled():
                _metrics.counter("stream.deletes").inc(len(gids))

    def update(self, ids, rows) -> None:
        """Replace the rows of live ids (tombstone the old, append the new).
        Capacity and shape are checked before the tombstoning, so a doomed
        insert cannot leave rows deleted with nothing appended."""
        gids = np.atleast_1d(np.asarray(ids, np.int64))
        rows = np.atleast_2d(np.asarray(rows, np.float32))
        self._check_gids(gids)
        if rows.shape != (len(gids), self.d):
            raise ValueError(f"rows must be ({len(gids)}, {self.d}), "
                             f"got {rows.shape}")
        if len(gids) > self._delta.capacity:
            raise ValueError(f"update of {len(gids)} rows exceeds delta "
                             f"capacity {self._delta.capacity}")
        if (self.compactor is not None and self.compactor.in_flight
                and self._delta.count + len(gids) > self._delta.capacity):
            # wait for the rebuild before taking the lock (the install
            # needs it); the delta has room afterwards
            self.compactor.join()
        with self._lock:
            if (self._oplog is not None
                    and self._delta.count + len(gids) > self._delta.capacity):
                raise RuntimeError("delta full while compaction in flight")
            # the delete half must not open the op log mid-update
            self._defer_trigger = True
            try:
                self.delete(gids)
                self.insert(gids, rows, _wait_ok=False)
            finally:
                self._defer_trigger = False
            if self.compactor is not None and self._oplog is None:
                self.compactor.maybe_trigger(self)

    # -- snapshot + search ---------------------------------------------------
    def snapshot(self) -> Snapshot:
        """The current (base, delta watermark, tombstone epoch) triple as
        tensors on the stream's device; cached until the next write. The
        base tensors are made here, on the caller's thread, the first time
        after each (re)build."""
        with self._lock:
            if self._snap is not None:
                return self._snap
            dev = self.device
            if self._base_dev is None:
                self._base_dev = to_device(self._base.arrays, dev)
            d = self._delta
            # a pow2 prefix of the delta buffer: a small delta does not pay
            # for the whole preallocation
            cap_q = min(d.capacity, next_pow2(max(d.count, 64)))

            def put(a):   # a copy the writers never touch
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev, copy=True)

            self._snap = Snapshot(
                arrays=self._base_dev,
                meta=self._base.meta,
                base_alive=put(self._base_alive),
                delta_x=put(d.x[:cap_q]),
                delta_gids=put(d.gids[:cap_q].astype(np.int32)),
                delta_valid=put(d.alive[:cap_q]),
                epoch=self._epoch,
                delta_count=d.count,
                n_base_dead=self._n_base_dead,
                clean=(self._n_base_dead == 0 and d.count == 0),
            )
            return self._snap

    def search(self, queries, k: int = 10,
               runtime: Optional[RuntimeConfig] = None):
        """Segment-merged c-k-AMIP search over the live rows. Returns
        (ids (B, k) GLOBAL, scores (B, k), StreamStats). A given
        RuntimeConfig is taken as it is, with k stamped in."""
        cfg = runtime if runtime is not None else RuntimeConfig()
        cfg = dataclasses.replace(cfg, k=k)
        return search_segments(self.snapshot(), queries, cfg,
                               device=self.device)

    # -- compaction ----------------------------------------------------------
    def _freeze_for_compaction(self) -> tuple[np.ndarray, np.ndarray]:
        """Copy out the surviving rows and open the op log (writes from here
        to `_install_compacted` are replayed onto the new base)."""
        with self._lock:
            if self._oplog is not None:
                raise RuntimeError("compaction already in flight")
            self._wal_append("compact_begin")
            gids, rows = self.alive_items()
            self._oplog = []
            return gids, rows

    def _install_compacted(self, new_base: ProMIPSIndex) -> None:
        """Swap in the rebuilt base, reset the delta and replay the writes
        that landed while the rebuild ran. Host state only: no device work
        (it runs on the compaction thread)."""
        with self._lock:
            self._wal_append("compact_commit")
            ops, self._oplog = self._oplog, None
            self._set_base(new_base)
            self._reset_delta()
            self._epoch += 1
            self._snap = None
            prev, self._wal_suspended = self._wal_suspended, True
            try:
                for op in ops:
                    if op[0] == "insert":
                        self.insert(op[1], op[2])
                    else:
                        self.delete(op[1])
            finally:
                self._wal_suspended = prev
        # counted here, so that background installs and compact() count alike
        if _metrics.enabled():
            _metrics.counter("stream.compactions").inc()

    def _abandon_compaction(self) -> None:
        """Close the op log without a swap (failed or empty rebuild)."""
        with self._lock:
            self._wal_append("compact_abort")
            self._oplog = None

    def compact(self) -> None:
        """Synchronous compaction (the background path is `self.compactor`).
        With no surviving rows there is nothing to rebuild from: the op log
        is closed and the tombstones stay (searches mask them)."""
        gids, rows = self._freeze_for_compaction()
        if len(gids) == 0:
            self._abandon_compaction()
            return
        try:
            new_base = rebuild_base(gids, rows, self.build_kwargs)
        except BaseException:
            self._abandon_compaction()
            raise
        self._install_compacted(new_base)

    def join_compaction(self, timeout: Optional[float] = None) -> None:
        if self.compactor is not None:
            self.compactor.join(timeout)

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> tuple[dict, dict]:
        """(arrays, meta) holding the whole mutable state, in the JAX
        package's layout: base arrays, tombstone bitmap, the filled delta
        prefix. `from_state` restores it without a rebuild."""
        with self._lock:
            if self._oplog is not None:
                raise RuntimeError("cannot serialize while a compaction is "
                                   "in flight (join_compaction() first)")
            arrays = {f"base_{f}": np.asarray(getattr(self._base.arrays, f))
                      for f in IndexArrays._fields}
            d = self._delta
            arrays.update(
                base_alive=self._base_alive.copy(),
                delta_x=d.x[: d.count].copy(),
                delta_gids=d.gids[: d.count].copy(),
                delta_alive=d.alive[: d.count].copy(),
            )
            meta = dict(
                meta=dataclasses.asdict(self._base.meta),
                build_kwargs=dict(self.build_kwargs),
                delta_capacity=int(d.capacity),
                next_id=int(self._next_id),
                wal_seq=int(self._wal_seq),
                auto_compact=self.compactor is not None,
                compaction=dataclasses.asdict(
                    self.compactor.cfg if self.compactor is not None
                    else CompactionConfig()),
            )
            return arrays, meta

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, *,
                   auto_compact: Optional[bool] = None,
                   compaction: Optional[CompactionConfig] = None,
                   device="cuda") -> "MutableProMIPS":
        """Inverse of :meth:`state_dict` (no index rebuild); also reads the
        JAX package's `MutableProMIPS.state_dict()`. Extra `IndexMeta` keys
        are ignored."""
        dev = resolve_device(device)
        names = {f.name for f in dataclasses.fields(IndexMeta)}
        base = ProMIPSIndex(
            arrays=IndexArrays(**{f: np.asarray(arrays[f"base_{f}"])
                                  for f in IndexArrays._fields}),
            meta=IndexMeta(**{k: v for k, v in meta["meta"].items()
                              if k in names}),
            layout=None,
        )
        obj = cls.__new__(cls)
        obj.device = dev
        obj.build_kwargs = dict(meta["build_kwargs"])
        obj.d = base.meta.d
        obj._lock = threading.RLock()
        obj._oplog = None
        obj._defer_trigger = False
        obj._init_wal_state()
        obj._wal_seq = obj._wal_floor = int(meta.get("wal_seq", 0))
        obj._delta_capacity = int(meta["delta_capacity"])
        obj._set_base(base)
        obj._base_alive = np.asarray(arrays["base_alive"], bool).copy()
        obj._n_base_dead = int(np.sum((base.arrays.ids >= 0)
                                      & ~obj._base_alive))
        obj._reset_delta()
        d = obj._delta
        count = len(arrays["delta_gids"])
        if count:
            d.x[:count] = arrays["delta_x"]
            d.gids[:count] = arrays["delta_gids"]
            d.alive[:count] = arrays["delta_alive"]
            d.count = count
            for slot in range(count):
                if d.alive[slot]:
                    obj._slot_of[int(d.gids[slot])] = slot
        obj._epoch = 0
        obj._snap = None
        obj._next_id = int(meta["next_id"])
        if auto_compact is None:
            auto_compact = bool(meta.get("auto_compact", False))
        if compaction is None:
            compaction = CompactionConfig(**meta.get("compaction", {}))
        obj.compactor = Compactor(compaction) if auto_compact else None
        return obj


__all__ = ["MutableProMIPS"]
