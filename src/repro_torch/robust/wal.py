"""Write-ahead log for the mutable index; port of `repro.robust.wal`, the
same record format byte for byte (each package reads the other's log).

Durability model: the WAL makes `MutableProMIPS` crash-safe *between*
snapshots. Every acknowledged write (insert / delete / update) and every
compaction lifecycle event (begin / commit / abort, positioned exactly at
the freeze / install / abandon points in the op order) is one
length-prefixed, CRC32-checksummed record:

    [u32 payload_len][u32 crc32(payload)][payload]
    payload = [u64 seq][u8 opcode][body]

Recovery = load the last good snapshot (checksummed, atomic — see
`robust/snapshot.py`) + replay every record with ``seq`` greater than the
snapshot's persisted ``wal_seq``. Because every mutation is deterministic
given its record (gids are explicit, `rebuild_base` is seeded and
canonical-ordered) and the compaction markers sit at the exact freeze /
install points, the recovered stream's searches are BIT-IDENTICAL — ids,
scores, every stats field — to the uncrashed stream (property-tested with
a crash at every record boundary in tests/test_torch_wal.py).

A torn final record (crash mid-write) is TRUNCATED, not an error: replay
stops at the last record whose length and CRC both verify, and recovery
trims the file so subsequent appends start clean. Corruption *before* the
tail (a flipped bit in an fsync'd record) is a real integrity failure and
raises `WalCorruptError` — silently dropping acknowledged ops would be a
lie.

``fsync`` policy per `WalConfig`:

    "always"  flush + os.fsync every append — survives power loss
    "os"      flush to the OS page cache every append — survives process
              crash, not power loss (the default: the property the tests
              exercise)
    "never"   library-buffered; flushed on close/checkpoint only
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..obs import metrics as _metrics
from .faultpoints import fault

__all__ = ["WAL_MAGIC", "WalConfig", "WalRecord", "WalCorruptError",
           "WriteAheadLog", "read_records", "recover"]

WAL_MAGIC = b"PWAL0001"
_HDR = struct.Struct("<II")          # payload_len, crc32
_SEQ_OP = struct.Struct("<QB")       # seq, opcode
_U32 = struct.Struct("<I")

_OPCODES = {"insert": 0x49, "delete": 0x44, "update": 0x55,
            "compact_begin": 0x42, "compact_commit": 0x43,
            "compact_abort": 0x41}
_OPNAMES = {v: k for k, v in _OPCODES.items()}
_ROW_OPS = ("insert", "update")


class WalCorruptError(RuntimeError):
    """Mid-log corruption: a record BEFORE the tail failed its CRC (a torn
    *final* record is normal crash debris and is truncated instead)."""


@dataclass(frozen=True)
class WalConfig:
    fsync: str = "os"     # "always" | "os" | "never"

    def __post_init__(self):
        if self.fsync not in ("always", "os", "never"):
            raise ValueError(f"unknown fsync policy {self.fsync!r}; valid "
                             "choices: always, os, never")


@dataclass(frozen=True)
class WalRecord:
    seq: int
    op: str                          # one of _OPCODES
    gids: Optional[np.ndarray] = None
    rows: Optional[np.ndarray] = None


def _encode(seq: int, op: str, gids=None, rows=None) -> bytes:
    parts = [_SEQ_OP.pack(seq, _OPCODES[op])]
    if op in _ROW_OPS:
        gids = np.ascontiguousarray(gids, np.int64)
        rows = np.ascontiguousarray(rows, np.float32)
        parts.append(_U32.pack(len(gids)))
        parts.append(_U32.pack(rows.shape[1]))
        parts.append(gids.tobytes())
        parts.append(rows.tobytes())
    elif op == "delete":
        gids = np.ascontiguousarray(gids, np.int64)
        parts.append(_U32.pack(len(gids)))
        parts.append(gids.tobytes())
    return b"".join(parts)


def _decode(payload: bytes) -> WalRecord:
    seq, opcode = _SEQ_OP.unpack_from(payload, 0)
    op = _OPNAMES[opcode]
    off = _SEQ_OP.size
    if op in _ROW_OPS:
        (n,) = _U32.unpack_from(payload, off)
        (d,) = _U32.unpack_from(payload, off + 4)
        off += 8
        gids = np.frombuffer(payload, np.int64, count=n, offset=off).copy()
        off += n * 8
        rows = np.frombuffer(payload, np.float32, count=n * d,
                             offset=off).reshape(n, d).copy()
        return WalRecord(seq, op, gids, rows)
    if op == "delete":
        (n,) = _U32.unpack_from(payload, off)
        gids = np.frombuffer(payload, np.int64, count=n, offset=off + 4).copy()
        return WalRecord(seq, op, gids)
    return WalRecord(seq, op)


class WriteAheadLog:
    """Append-only checksummed op log bound to one file.

    ``fresh=True`` truncates any existing file and writes the magic;
    otherwise the file is opened for append at ``append_at`` (recovery
    passes the verified good length so a torn tail is overwritten)."""

    def __init__(self, path: str, fsync: str = "os", *, fresh: bool = False,
                 append_at: Optional[int] = None):
        self.path = os.path.abspath(path)
        self.cfg = WalConfig(fsync=fsync)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        exists = os.path.exists(self.path)
        self._f = open(self.path, "wb" if fresh or not exists else "r+b")
        if fresh or not exists:
            self._f.write(WAL_MAGIC)
            self._f.flush()
        else:
            self._f.seek(append_at if append_at is not None
                         else os.path.getsize(self.path))
            if append_at is not None:
                self._f.truncate(append_at)

    def append(self, seq: int, op: str, gids=None, rows=None) -> None:
        """Durably append one record (per the fsync policy). The
        ``wal.append`` fault fires BEFORE any bytes are written (clean op
        loss); ``wal.torn`` fires after HALF the record (torn tail)."""
        fault.at("wal.append")
        payload = _encode(seq, op, gids, rows)
        blob = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
        if fault.fires("wal.torn"):
            self._f.write(blob[: max(1, len(blob) // 2)])
            self._f.flush()
            raise OSError(f"injected torn write at {self.path!r}")
        self._f.write(blob)
        if self.cfg.fsync != "never":
            self._f.flush()
            if self.cfg.fsync == "always":
                os.fsync(self._f.fileno())
        if _metrics.enabled():
            _metrics.counter("stream.wal_appends").inc()
            _metrics.counter("stream.wal_bytes").inc(len(blob))

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def reset(self) -> None:
        """Truncate to an empty log (after a checkpoint baked every op into
        the snapshot). Sequence numbers keep counting — the snapshot's
        ``wal_seq`` is what replay skips against, so a crash between the
        snapshot landing and this truncate is harmless."""
        self._f.seek(0)
        self._f.truncate(0)
        self._f.write(WAL_MAGIC)
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str) -> Tuple[List[WalRecord], int, bool]:
    """Parse a WAL file tolerantly.

    Returns ``(records, good_length, clean)``: every record up to the
    first torn/corrupt point, the byte offset of the last good record's
    end (the truncation point for re-opening), and whether the file ended
    exactly on a record boundary. A bad CRC followed by MORE parseable
    bytes is mid-log corruption (not crash debris) and raises
    `WalCorruptError`.
    """
    with open(path, "rb") as f:
        blob = f.read()
    if blob[: len(WAL_MAGIC)] != WAL_MAGIC:
        raise WalCorruptError(f"{path!r}: bad WAL magic "
                              f"{blob[:len(WAL_MAGIC)]!r}")
    records: List[WalRecord] = []
    off = len(WAL_MAGIC)
    while True:
        if off + _HDR.size > len(blob):
            break                                   # torn/absent header
        length, crc = _HDR.unpack_from(blob, off)
        start, end = off + _HDR.size, off + _HDR.size + length
        if end > len(blob):
            break                                   # torn payload
        payload = blob[start:end]
        if zlib.crc32(payload) != crc:
            if end < len(blob):
                raise WalCorruptError(
                    f"{path!r}: CRC mismatch at offset {off} with "
                    f"{len(blob) - end} bytes following — mid-log "
                    "corruption, not a torn tail; acknowledged ops would "
                    "be silently lost. Restore the file from backup.")
            break                                   # torn final record
        records.append(_decode(payload))
        off = end
    return records, off, off == len(blob)


def replay_into(stream, records, base_seq: int = 0) -> int:
    """Apply WAL records with ``seq > base_seq`` onto a restored stream.

    Mirrors the live execution exactly: ops go through the public mutation
    methods (so delta slots, tombstones and the op log fill identically),
    ``compact_begin`` freezes, ``compact_commit`` rebuilds + installs,
    ``compact_abort`` abandons. A pending freeze at end-of-log (crash
    mid-rebuild) is abandoned — exactly what the crashed process lost.
    Returns the last applied seq.
    """
    from ..stream.compaction import rebuild_base

    last = base_seq
    pending = None
    stream._wal_replaying = True
    try:
        for rec in records:
            if rec.seq <= base_seq:
                continue
            if rec.op == "insert":
                stream.insert(rec.gids, rec.rows)
            elif rec.op == "delete":
                stream.delete(rec.gids)
            elif rec.op == "update":
                stream.update(rec.gids, rec.rows)
            elif rec.op == "compact_begin":
                pending = stream._freeze_for_compaction()
            elif rec.op == "compact_commit":
                gids, rows = pending
                stream._install_compacted(
                    rebuild_base(gids, rows, stream.build_kwargs))
                pending = None
            elif rec.op == "compact_abort":
                stream._abandon_compaction()
                pending = None
            last = rec.seq
        if stream._oplog is not None:   # crash mid-compaction: drop the
            stream._abandon_compaction()  # in-flight rebuild, keep the ops
    finally:
        stream._wal_replaying = False
    return last


def recover(wal_dir: str, *, attach: bool = True, fsync: str = "os",
            device="cuda"):
    """Recover a WAL'd `promips-stream` searcher from its durability dir.

    ``wal_dir`` is the directory `api.build(..., wal_dir=...)` maintains:
    ``snapshot/`` (checksummed atomic save) + ``wal.log``. Loads the
    snapshot (manifest-verified), replays every record past the snapshot's
    ``wal_seq``, truncates any torn tail, and (with ``attach=True``)
    re-attaches the WAL for continued appends. The searcher's tensors live
    on ``device`` (the card unless ``device="cpu"``). Returns the searcher.
    """
    from .. import api   # lazy: robust must stay importable below api

    snap = os.path.join(wal_dir, "snapshot")
    wal_path = os.path.join(wal_dir, "wal.log")
    searcher = api.load(snap, device=device)
    stream = getattr(searcher, "inner", None)
    if stream is None or not hasattr(stream, "_wal_seq"):
        raise ValueError(f"snapshot at {snap!r} is a "
                         f"{searcher.name!r} index, not a WAL-capable "
                         "promips-stream")
    if os.path.exists(wal_path):
        records, good_len, _clean = read_records(wal_path)
        last = replay_into(stream, records, base_seq=stream._wal_seq)
        stream._wal_seq = max(stream._wal_seq, last)
        if attach:
            stream.attach_wal(WriteAheadLog(wal_path, fsync=fsync,
                                            append_at=good_len))
    elif attach:
        stream.attach_wal(WriteAheadLog(wal_path, fsync=fsync, fresh=True))
    searcher._wal_dir = wal_dir
    return searcher
