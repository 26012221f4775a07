"""The port's write-ahead log against the JAX package's, on the CPU.

Held: `_encode` gives the JAX bytes for every opcode; each package reads
the other's log; a torn tail is truncated and mid-log corruption raises;
the fsync policy is validated; a non-mutable backend is refused; a crash
at every record boundary (a torn next record on top) recovers to the
uncrashed stream's ids, scores and every stats field bit for bit; a
checkpoint's records are skipped on replay; a ``wal.append`` fault rejects
the op cleanly; the same op script gives the JAX log's bytes (every write
and compaction marker logged in the JAX order); and a JAX ``wal_dir``
written by it recovers in the port to the JAX `recover`'s results (ids
and stats equal, scores within 1e-5 relative: each package rescores the
winners with its own einsum).
"""
import os

import jax
import numpy as np
import pytest

from repro import api as jax_api
from repro.robust import read_records as jax_read_records
from repro.robust import recover as jax_recover
from repro.robust import wal as jax_wal
from repro_torch import api
from repro_torch.robust import (FaultInjected, WAL_MAGIC, WalCorruptError,
                                WriteAheadLog, fault, read_records, recover)
from repro_torch.robust import wal
from repro_torch.robust.wal import _HDR
from repro_torch.stream import MutableProMIPS

D = 16
BUILD = dict(m=4)
REL = 1e-5


@pytest.fixture(autouse=True)
def _clean_faults():
    fault.disarm()
    yield
    fault.disarm()


@pytest.fixture
def jax_clean(monkeypatch):
    """`jax.core.trace_state_clean`, which the JAX `runtime.search` asks for
    and this jax lacks, set for one test."""
    monkeypatch.setattr(jax.core, "trace_state_clean", lambda: True,
                        raising=False)


def _corpus(n=240, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, D).astype(np.float32), rng


def _queries(rng, b=5):
    return rng.randn(b, D).astype(np.float32)


def _result_tuple(searcher, q, k=8):
    res = searcher.search(q, k=k)
    stats = dict(res.stats)
    stats.pop("wall_time_s", None)
    return np.asarray(res.ids), np.asarray(res.scores), stats


def _stream_result(stream, q, k=8):
    ids, scores, stats = stream.search(q, k=k)
    return ids.numpy(), scores.numpy(), stats.to_dict()


def _record_boundaries(wal_path):
    """Byte offset of every record boundary (including the magic-only 0th)."""
    with open(wal_path, "rb") as f:
        blob = f.read()
    offs = [len(WAL_MAGIC)]
    off = len(WAL_MAGIC)
    while off + _HDR.size <= len(blob):
        length, _crc = _HDR.unpack_from(blob, off)
        off += _HDR.size + length
        assert off <= len(blob)
        offs.append(off)
    return blob, offs


def _write(path, blob):
    with open(path, "wb") as f:
        f.write(blob)


# ---------------------------------------------------------------------------
# the record format, byte for byte
# ---------------------------------------------------------------------------

def _record_args(op, rng):
    if op in ("insert", "update"):
        return rng.randint(0, 1 << 31, 3), rng.randn(3, D).astype(np.float32)
    if op == "delete":
        return rng.randint(0, 1 << 31, 4), None
    return None, None


@pytest.mark.parametrize("op", ["insert", "delete", "update", "compact_begin",
                                "compact_commit", "compact_abort"])
def test_encode_gives_the_jax_bytes(op):
    assert WAL_MAGIC == jax_wal.WAL_MAGIC
    assert wal._OPCODES == jax_wal._OPCODES
    gids, rows = _record_args(op, np.random.RandomState(len(op)))
    assert wal._encode(7, op, gids, rows) == jax_wal._encode(7, op, gids, rows)


_SCRIPT_OPS = ["insert", "delete", "update", "compact_begin",
               "compact_commit", "insert", "compact_begin", "compact_abort"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_log(tmp_path, writer):
    rng = np.random.RandomState(3)
    path = str(tmp_path / "wal.log")
    log_cls = WriteAheadLog if writer == "port" else jax_wal.WriteAheadLog
    reader = jax_read_records if writer == "port" else read_records
    args = [_record_args(op, rng) for op in _SCRIPT_OPS]
    with log_cls(path, fresh=True) as log:
        for seq, (op, (gids, rows)) in enumerate(zip(_SCRIPT_OPS, args), 1):
            log.append(seq, op, gids, rows)
    recs, good, clean = reader(path)
    assert clean and good == os.path.getsize(path)
    assert [r.op for r in recs] == _SCRIPT_OPS
    assert [r.seq for r in recs] == list(range(1, len(_SCRIPT_OPS) + 1))
    for rec, (gids, rows) in zip(recs, args):
        if gids is not None:
            np.testing.assert_array_equal(rec.gids, gids)
        if rows is not None:
            assert rec.rows.dtype == np.float32
            np.testing.assert_array_equal(rec.rows, rows)


def test_wal_records_roundtrip(tmp_path):
    x, rng = _corpus()
    wd = str(tmp_path / "wal")
    s = api.build(x, backend="promips-stream", seed=1, wal_dir=wd,
                  delta_capacity=64, device="cpu", **BUILD)
    s.insert([500, 501], rng.randn(2, D))
    s.delete([0, 1])
    s.update([10], rng.randn(1, D))
    recs, good, clean = read_records(os.path.join(wd, "wal.log"))
    assert clean
    assert [r.op for r in recs] == ["insert", "delete", "delete", "insert"]
    assert [r.seq for r in recs] == [1, 2, 3, 4]
    assert np.array_equal(recs[0].gids, [500, 501])
    assert recs[0].rows.shape == (2, D) and recs[0].rows.dtype == np.float32
    assert s.wal_lag() == 4
    assert s.maintenance_status() == {"compaction": None, "wal_attached": True,
                                      "wal_lag": 4}


def test_wal_torn_tail_truncated_midlog_corruption_fatal(tmp_path):
    x, rng = _corpus()
    wd = str(tmp_path / "wal")
    s = api.build(x, backend="promips-stream", seed=1, wal_dir=wd,
                  delta_capacity=64, device="cpu", **BUILD)
    s.insert([500], rng.randn(1, D))
    s.delete([0])
    path = os.path.join(wd, "wal.log")
    blob, offs = _record_boundaries(path)

    # torn tail: half of the final record -> truncated, not an error
    _write(path, blob[: (offs[1] + offs[2]) // 2])
    recs, good, clean = read_records(path)
    assert [r.op for r in recs] == ["insert"] and not clean
    assert good == offs[1]

    # mid-log corruption: flip a byte of record 0's payload -> fatal
    bad = bytearray(blob)
    bad[offs[0] + _HDR.size + 2] ^= 0xFF
    _write(path, bytes(bad))
    with pytest.raises(WalCorruptError, match="mid-log"):
        read_records(path)
    _write(path, b"NOTAWAL0" + blob[len(WAL_MAGIC):])
    with pytest.raises(WalCorruptError, match="magic"):
        read_records(path)


def test_wal_fsync_policy_validated(tmp_path):
    with pytest.raises(ValueError, match="fsync"):
        api.build(_corpus(n=120)[0], backend="promips-stream", seed=1,
                  wal_dir=str(tmp_path / "w"), wal_fsync="sometimes",
                  device="cpu", **BUILD)
    for policy in ("always", "os", "never"):
        with WriteAheadLog(str(tmp_path / policy / "wal.log"), policy,
                           fresh=True) as log:
            log.append(1, "delete", np.array([3]))
        assert [r.op for r in read_records(log.path)[0]] == ["delete"]


def test_wal_requires_mutable_backend(tmp_path):
    x, _ = _corpus()
    with pytest.raises(ValueError, match="wal_dir"):
        api.build(x, backend="promips", seed=1, wal_dir=str(tmp_path / "w"),
                  device="cpu", **BUILD)
    # and recover() refuses a non-stream snapshot
    s = api.build(x, backend="promips", seed=1, device="cpu", **BUILD)
    s.save(str(tmp_path / "r" / "snapshot"))
    with pytest.raises(ValueError, match="WAL-capable"):
        recover(str(tmp_path / "r"), device="cpu")


# ---------------------------------------------------------------------------
# crash-recovery bit-parity, a crash injected at EVERY record boundary
# ---------------------------------------------------------------------------

def _op_script(rng):
    """(op, args) script covering insert/delete/update/compact."""
    return [
        ("insert", np.arange(400, 420), rng.randn(20, D).astype(np.float32)),
        ("delete", np.arange(0, 30)),
        ("update", np.arange(50, 60), rng.randn(10, D).astype(np.float32)),
        ("compact",),
        ("insert", np.arange(420, 425), rng.randn(5, D).astype(np.float32)),
        ("delete", np.array([400, 410, 422])),
        ("compact",),
        ("update", np.array([50, 421]), rng.randn(2, D).astype(np.float32)),
    ]


def _apply(target, op):
    kind = op[0]
    if kind == "insert":
        target.insert(op[1], op[2])
    elif kind == "delete":
        target.delete(op[1])
    elif kind == "update":
        target.update(op[1], op[2])
    else:
        target.compact()


def _shadow_steps(script):
    """The script as one shadow transition per WAL record: update = its
    delete half, then its insert half; compact = begin (a no-op on the
    state) then commit (the whole compaction)."""
    steps = []
    for op in script:
        if op[0] == "update":
            steps.append(("delete", op[1]))
            steps.append(("insert", op[1], op[2]))
        elif op[0] == "compact":
            steps.append(("noop",))
            steps.append(("compact",))
        else:
            steps.append(op)
    return steps


def test_crash_recovery_bit_parity_every_boundary(tmp_path):
    """For a crash at every record boundary (with a torn next record),
    snapshot + replay gives a stream whose searches equal, bit for bit in
    ids, scores and every stats field, those of a stream without a WAL that
    ran the same prefix."""
    x, rng = _corpus(n=300, seed=4)
    q = _queries(rng)
    wd = str(tmp_path / "wal")
    primary = api.build(x, backend="promips-stream", seed=2, wal_dir=wd,
                        delta_capacity=128, device="cpu", **BUILD)
    script = _op_script(rng)
    for op in script:
        _apply(primary, op)
    path = os.path.join(wd, "wal.log")
    blob, offs = _record_boundaries(path)
    steps = _shadow_steps(script)
    assert len(offs) == len(steps) + 1, "script/record accounting drifted"

    shadow = MutableProMIPS(x, delta_capacity=128, device="cpu",
                            **dict(BUILD, seed=2))
    shadow_states = [_stream_result(shadow, q)]
    for st in steps:
        if st[0] != "noop":
            _apply(shadow, st)
        shadow_states.append(_stream_result(shadow, q))

    for i, off in enumerate(offs):
        _write(path, blob[:off])
        if i + 1 < len(offs):  # torn next record on top of a clean prefix
            with open(path, "ab") as f:
                f.write(blob[off: (off + offs[i + 1]) // 2 + 1])
        rec = recover(wd, attach=False, device="cpu")
        got = _result_tuple(rec, q)
        want = shadow_states[i]
        assert np.array_equal(got[0], want[0]), f"ids diverge at boundary {i}"
        assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32)), \
            f"scores diverge at boundary {i}"
        assert got[2] == want[2], f"stats diverge at boundary {i}"
        # a compaction the crash cut short is abandoned: the next one runs
        rec.compact()
    # the last recovery re-attached the log at its good length: it appends on
    rec = recover(wd, device="cpu")
    rec.insert([999], rng.randn(1, D))
    recs, _, clean = read_records(path)
    assert clean and recs[-1].op == "insert" and recs[-1].seq == len(steps) + 1


def test_recovery_after_checkpoint_skips_baked_records(tmp_path):
    """A crash between the checkpoint's save and the log's truncate must not
    apply a record twice: replay skips seq <= the snapshot's wal_seq."""
    x, rng = _corpus()
    q = _queries(rng)
    wd = str(tmp_path / "wal")
    s = api.build(x, backend="promips-stream", seed=1, wal_dir=wd,
                  delta_capacity=64, device="cpu", **BUILD)
    s.insert([500, 501], rng.randn(2, D))
    s.delete([0])
    # checkpoint WITHOUT truncating the log = the torn middle state
    s.save(os.path.join(wd, "snapshot"))
    s.inner.mark_wal_floor()
    s.insert([502], rng.randn(1, D))
    ref = _result_tuple(s, q)
    rec = recover(wd, attach=False, device="cpu")
    got = _result_tuple(rec, q)
    assert np.array_equal(ref[0], got[0])
    assert np.array_equal(ref[1], got[1])
    assert ref[2] == got[2]
    assert rec.inner._wal_seq == s.inner._wal_seq
    # a full checkpoint empties the log and keeps the seq
    s.checkpoint()
    recs, _, _ = read_records(os.path.join(wd, "wal.log"))
    assert recs == [] and s.wal_lag() == 0
    got = _result_tuple(recover(wd, attach=False, device="cpu"), q)
    assert np.array_equal(ref[0], got[0]) and ref[2] == got[2]


def test_wal_append_fault_rejects_op_cleanly(tmp_path):
    """A failed WAL append rejects the op before any state changes:
    acknowledged implies logged."""
    x, rng = _corpus()
    wd = str(tmp_path / "wal")
    s = api.build(x, backend="promips-stream", seed=1, wal_dir=wd,
                  delta_capacity=64, device="cpu", **BUILD)
    s.insert([500], rng.randn(1, D))
    before = s.n
    fault.arm("wal.append", times=1)
    with pytest.raises(FaultInjected):
        s.insert([501], rng.randn(1, D))
    assert s.n == before
    with pytest.raises(KeyError):
        s.delete([501])  # never applied
    s.insert([501], rng.randn(1, D))  # fault exhausted; op logs + applies
    recs, _, _ = read_records(os.path.join(wd, "wal.log"))
    assert [r.seq for r in recs] == [1, 2], "failed append must not burn seq"
    # a torn append: the op is rejected, and recovery truncates the debris
    fault.arm("wal.torn", times=1)
    with pytest.raises(OSError, match="torn"):
        s.insert([502], rng.randn(1, D))
    recs, good, clean = read_records(os.path.join(wd, "wal.log"))
    assert [r.seq for r in recs] == [1, 2] and not clean
    assert recover(wd, attach=False, device="cpu").n == s.n


def test_jax_wal_dir_recovers_in_the_port(tmp_path, jax_clean):
    """The same op script through a JAX stream with a WAL: the port's
    `recover` of that directory gives the JAX `recover`'s results, at the
    full log and with the log cut after every record."""
    x, rng = _corpus(n=300, seed=4)
    q = _queries(rng)
    wd = str(tmp_path / "wal")
    primary = jax_api.build(x, backend="promips-stream", seed=2, wal_dir=wd,
                            delta_capacity=128, **BUILD)
    ours = api.build(x, backend="promips-stream", seed=2,
                     wal_dir=str(tmp_path / "port"), delta_capacity=128,
                     device="cpu", **BUILD)
    for op in _op_script(rng):
        _apply(primary, op)
        _apply(ours, op)
    path = os.path.join(wd, "wal.log")
    # the port logs the same records in the same order: the same bytes
    with open(path, "rb") as f, open(tmp_path / "port" / "wal.log", "rb") as g:
        assert f.read() == g.read()
    blob, offs = _record_boundaries(path)
    for off in offs:
        _write(path, blob[:off])
        want = _result_tuple(jax_recover(wd, attach=False), q)
        got = _result_tuple(recover(wd, attach=False, device="cpu"), q)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[2] == want[2]
        fin = np.isfinite(want[1])
        np.testing.assert_array_equal(np.isfinite(got[1]), fin)
        assert (np.abs(got[1][fin] - want[1][fin])
                <= REL * np.abs(want[1][fin]) + 1e-6).all()
