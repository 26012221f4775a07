"""The port's checksummed snapshot directories and `save` / `load`, on the
CPU, against the JAX package's.

Held: the manifest is written (the JAX format and version, a SHA256 a
file) and verifies; the corruption matrix (truncated arrays, a flipped
byte of meta.json, a listed file missing, an unreadable manifest) raises
`CorruptSnapshotError` naming the file; a directory without a manifest
loads with a warning; a fault injected mid-save leaves the previous
snapshot intact; the provenance names the torch build and no JAX. Every
backend (``promips``, ``promips-stream`` and ``sharded``, each after some
churn where it takes writes, and the four baselines) saved by one package
loads in the other (and in its own) with equal searches: ids and stats
equal, scores equal bit for bit on the host engines and within 1e-5
relative on the device search (each package rescores with its own einsum).
"""
import json
import os
import shutil

import jax
import numpy as np
import pytest

from repro import api as jax_api
from repro_torch import api
from repro_torch.robust import (CorruptSnapshotError, FaultInjected, fault,
                                verify_dir)
from repro_torch.robust.snapshot import provenance

D = 16
REL = 1e-5
BACKENDS = {
    "promips": dict(m=4),
    "promips-stream": dict(m=4, delta_capacity=64),
    "sharded": dict(m=4, n_shards=3, delta_capacity=64),
    "exact": {},
    "h2alsh": {},
    "pq": {},
    "rangelsh": {},
}


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


def _result_tuple(searcher, q, k=8):
    res = searcher.search(q, k=k)
    stats = dict(res.stats)
    stats.pop("wall_time_s", None)
    return np.asarray(res.ids), np.asarray(res.scores), stats


@pytest.fixture(scope="module")
def saved_index(tmp_path_factory):
    x, rng = _corpus()
    s = api.build(x, backend="promips", seed=5, m=4, device="cpu")
    path = str(tmp_path_factory.mktemp("snap") / "idx")
    s.save(path)
    q = rng.randn(5, D).astype(np.float32)
    return path, q, _result_tuple(s, q)


def _copy_dir(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def test_snapshot_manifest_written_and_verifies(saved_index):
    path, q, want = saved_index
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert set(man["files"]) == {"arrays.npz", "meta.json"}
    assert man["format"] == "repro.api-index" and man["version"] == 1
    assert all(len(h) == 64 for h in man["files"].values())
    assert verify_dir(path) is True
    got = _result_tuple(api.load(path, device="cpu"), q)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32))
    assert got[2] == want[2]
    assert api.saved_bytes(path) == sum(
        os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    assert api.read_header(path)["backend"] == "promips"


def test_snapshot_provenance_names_no_jax(saved_index):
    path, _, _ = saved_index
    with open(os.path.join(path, "manifest.json")) as f:
        prov = json.load(f)["provenance"]
    assert prov == provenance()
    assert set(prov) == {"commit", "torch_version", "cuda_version", "device"}
    assert prov["device"] == "cpu" and "jax" not in json.dumps(prov).lower()


def test_snapshot_corruption_matrix(saved_index, tmp_path):
    path, _, _ = saved_index
    # truncated arrays.npz
    p1 = _copy_dir(path, tmp_path / "trunc")
    f = os.path.join(p1, "arrays.npz")
    with open(f, "r+b") as fh:
        fh.truncate(os.path.getsize(f) // 2)
    with pytest.raises(CorruptSnapshotError, match="arrays.npz"):
        api.load(p1, device="cpu")
    # bit-flipped meta.json
    p2 = _copy_dir(path, tmp_path / "flip")
    f = os.path.join(p2, "meta.json")
    with open(f, "rb") as fh:
        b = bytearray(fh.read())
    b[len(b) // 2] ^= 0x01
    with open(f, "wb") as fh:
        fh.write(bytes(b))
    with pytest.raises(CorruptSnapshotError, match="meta.json"):
        api.load(p2, device="cpu")
    # manifest-listed file missing on disk
    p3 = _copy_dir(path, tmp_path / "missing")
    os.remove(os.path.join(p3, "arrays.npz"))
    with pytest.raises(CorruptSnapshotError, match="missing"):
        api.load(p3, device="cpu")
    # unreadable manifest
    p4 = _copy_dir(path, tmp_path / "badman")
    with open(os.path.join(p4, "manifest.json"), "w") as fh:
        fh.write("{not json")
    with pytest.raises(CorruptSnapshotError, match="manifest.json"):
        api.load(p4, device="cpu")
    # no saved index at all, and a load through the wrong backend class
    with pytest.raises(FileNotFoundError):
        api.load(str(tmp_path / "nothing"), device="cpu")
    with pytest.raises(ValueError, match="saved by backend"):
        api.get_backend("exact").load(path, device="cpu")


def test_legacy_manifestless_snapshot_loads_with_warning(saved_index,
                                                          tmp_path):
    path, q, want = saved_index
    p = _copy_dir(path, tmp_path / "legacy")
    os.remove(os.path.join(p, "manifest.json"))
    with pytest.warns(UserWarning, match="UNVERIFIED"):
        s = api.load(p, device="cpu")
    got = _result_tuple(s, q)
    assert np.array_equal(got[0], want[0])


def test_save_is_atomic_under_injected_fault(saved_index, tmp_path):
    """A fault mid-save leaves the previous snapshot fully intact."""
    path, q, want = saved_index
    p = _copy_dir(path, tmp_path / "atomic")
    s = api.load(p, device="cpu")
    fault.arm("snapshot.write", after=1, times=1)  # fail on the 2nd file
    with pytest.raises(FaultInjected):
        s.save(p)
    s2 = api.load(p, device="cpu")  # previous snapshot still verifies + loads
    got = _result_tuple(s2, q)
    assert np.array_equal(got[0], want[0])
    assert not [d for d in os.listdir(os.path.dirname(p))
                if d.startswith(".save-tmp")], "temp dir leaked"
    # a save that completes replaces the directory in place
    s.save(p)
    assert verify_dir(p) and np.array_equal(
        _result_tuple(api.load(p, device="cpu"), q)[0], want[0])


def _churn(s, x, rng):
    """A few writes on a backend that takes them (a no-op otherwise)."""
    if not s.capabilities.supports_mutation:
        return
    n = len(x)
    s.insert(np.arange(n, n + 12), rng.randn(12, D).astype(np.float32))
    s.delete([0, 1, n + 3, n - 1])
    s.update([5, n + 4], rng.randn(2, D).astype(np.float32))


@pytest.mark.parametrize("direction", ["port->jax", "jax->port", "port->port"])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_cross_package_save_and_load(tmp_path, jax_clean, backend, direction):
    x, rng = _corpus(n=600, seed=7)
    q = rng.randn(6, D).astype(np.float32)
    opts = BACKENDS[backend]
    writer, reader = direction.split("->")
    if writer == "port":
        s = api.build(x, backend=backend, seed=3, page_bytes=1024,
                      device="cpu", **opts)
    else:
        s = jax_api.build(x, backend=backend, seed=3, page_bytes=1024, **opts)
    _churn(s, x, np.random.RandomState(1))
    want = _result_tuple(s, q)
    path = s.save(str(tmp_path / "idx"))
    loaded = (api.load(path, device="cpu") if reader == "port"
              else jax_api.load(path))
    assert loaded.name == backend and loaded.seed == 3 and loaded.n == s.n
    assert loaded.guarantee.k == s.guarantee.k
    got = _result_tuple(loaded, q)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2] == want[2]
    if writer == reader or backend not in ("promips", "promips-stream",
                                           "sharded"):
        np.testing.assert_array_equal(got[1], want[1])
    else:
        fin = np.isfinite(want[1])
        np.testing.assert_array_equal(np.isfinite(got[1]), fin)
        assert (np.abs(got[1][fin] - want[1][fin])
                <= REL * np.abs(want[1][fin]) + 1e-6).all()
    if backend in ("promips", "promips-stream", "sharded"):
        assert loaded.runtime.verification == s.runtime.verification
