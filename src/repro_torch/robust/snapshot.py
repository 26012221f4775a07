"""Checksummed atomic snapshot directories; port of
`repro.robust.snapshot` (the same manifest, so that each package verifies
the other's directories).

A saved index directory gains a ``manifest.json``:

    {"format": "repro.api-index", "version": 1,
     "files": {"arrays.npz": "<sha256>", "meta.json": "<sha256>"},
     "provenance": {"commit": ..., "torch_version": ..., "cuda_version": ...,
                    "device": ...}}

and the whole directory is written ATOMICALLY: all files land in a temp
dir next to the destination, are fsync'd, and the temp dir is renamed into
place — a crash mid-save leaves either the previous snapshot or the new
one, never a torn mix. `verify_dir` re-hashes every manifest entry at load
time and raises `CorruptSnapshotError` naming the FIRST file that failed
(missing, truncated, or bit-flipped), so corruption fail-fasts with an
actionable message instead of surfacing as a numpy unpickling error three
layers down. A directory without a manifest (pre-durability save) loads
with a warning, unverified.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import warnings
from typing import Callable, Dict

import torch

from .faultpoints import fault

__all__ = ["CorruptSnapshotError", "MANIFEST_FILE", "provenance",
           "verify_dir", "write_atomic_dir"]

MANIFEST_FILE = "manifest.json"
_HASH_CHUNK = 1 << 20


class CorruptSnapshotError(RuntimeError):
    """A saved index failed integrity verification; the message names the
    file that failed and why (missing / size mismatch / hash mismatch)."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_HASH_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def provenance() -> dict:
    """Code and toolchain identity stamped into every manifest: the commit,
    the torch and CUDA versions, and the name of the card (or "cpu")."""
    try:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=root, capture_output=True,
            text=True, timeout=10, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        commit = "unknown"
    device = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
              else "cpu")
    return {"commit": commit, "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda or "none", "device": device}


def write_atomic_dir(path: str, writers: Dict[str, Callable[[str], None]],
                     manifest_extra: dict = None) -> str:
    """Write a snapshot directory atomically.

    ``writers`` maps each file name to a callable that writes it given a
    full path; every file is hashed into the manifest as it is written.
    The ``snapshot.write`` fault point fires once per file, BEFORE the
    write — an injected fault aborts the temp dir and leaves any previous
    snapshot at ``path`` untouched.
    """
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".save-tmp-")
    try:
        files = {}
        for fname, write in writers.items():
            fault.at("snapshot.write")
            fpath = os.path.join(tmp, fname)
            write(fpath)
            files[fname] = _sha256(fpath)
        manifest = {"files": files, "provenance": provenance()}
        manifest.update(manifest_extra or {})
        fault.at("snapshot.write")
        mpath = os.path.join(tmp, MANIFEST_FILE)
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
        for fname in list(files) + [MANIFEST_FILE]:
            fd = os.open(os.path.join(tmp, fname), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        # atomic install: rename the old dir aside, the temp dir in, then
        # drop the old one. The only non-atomic window is between the two
        # renames (dest briefly absent); both endpoints are complete,
        # verified snapshots, so a crash never leaves a torn mix.
        if os.path.exists(path):
            old = tempfile.mkdtemp(dir=parent, prefix=".save-old-")
            os.rmdir(old)
            os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def verify_dir(path: str) -> bool:
    """Verify a snapshot directory against its manifest.

    Returns True when verified, False when there is no manifest (legacy
    pre-durability save — a warning is emitted and the caller loads it
    unverified). Raises `CorruptSnapshotError` naming the failing file on
    a missing entry, size mismatch, or hash mismatch, and on an unreadable
    manifest itself.
    """
    mpath = os.path.join(path, MANIFEST_FILE)
    if not os.path.exists(mpath):
        warnings.warn(
            f"saved index at {path!r} has no {MANIFEST_FILE} (written by a "
            "pre-durability version); loading UNVERIFIED — re-save to gain "
            "integrity checking", stacklevel=3)
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (ValueError, KeyError) as e:
        raise CorruptSnapshotError(
            f"snapshot at {path!r}: unreadable {MANIFEST_FILE} ({e}); the "
            "snapshot cannot be trusted — restore from a backup or re-save "
            "from a live index") from e
    for fname, want in files.items():
        fpath = os.path.join(path, fname)
        if not os.path.exists(fpath):
            raise CorruptSnapshotError(
                f"snapshot at {path!r}: {fname} is listed in the manifest "
                "but missing on disk")
        got = _sha256(fpath)
        if got != want:
            raise CorruptSnapshotError(
                f"snapshot at {path!r}: {fname} failed its checksum "
                f"(manifest sha256 {want[:12]}…, on-disk {got[:12]}…) — "
                "the file is truncated or corrupted")
    return True
