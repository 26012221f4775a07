"""Tuning cache, read side; port of `repro.tune.cache`.

The same file as the JAX package's (default ``results/tune/tuning.json`` at
the repo root; the env var ``REPRO_TUNE_CACHE`` overrides the path, and the
empty string disables lookups). Entries are keyed by `space.shape_key`, whose
platform part names the device and the torch version, so a port entry never
matches a JAX entry and the reverse:

  {"version": 1,
   "entries": {
     "n131072:d128:cuda-NVIDIA H100 80GB HBM3:torch2.x.y": {
       "runtime": {"verification": ..., "dense_frac": ..., "tile_cap": ...,
                   "prefilter_eps": ...},
       "build":   {"page_bytes": ..., "max_probe_groups": ...},
       "serve":   {"decode_batch_slots": ..., ...}}}}

`core.runtime.search`, `api.build`, the stream adapter and
`serve.DecodeEngine` consult `resolved()` wherever the caller left a tuned
knob at its None sentinel, as the JAX package's callers do. A missing file,
key or field resolves to `space.HAND_PICKED`. Reads are memoized on (path,
mtime, size), and a memoized path is stat'ed again at most once every
`RECHECK_S` seconds (a stat costs tens of microseconds on some file systems,
and it would otherwise run on every search); `clear_memo` makes the next read
stat at once. `save_entry` (the tuner's writer, `tune.search.tune_point`)
adds or replaces the entry under the port's own key and drops the memo, so
the next lookup reads it.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from datetime import datetime, timezone
from typing import Any, Dict, Optional

import torch

from . import space

ENV_VAR = "REPRO_TUNE_CACHE"
_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))
DEFAULT_PATH = os.path.join(_REPO_ROOT, "results", "tune", "tuning.json")

RECHECK_S = 1.0

_memo: Dict[str, tuple] = {}   # path -> ((mtime, size) or None, data, checked)


def cache_path() -> Optional[str]:
    """Active cache path, or None when lookups are disabled
    (``REPRO_TUNE_CACHE=""``)."""
    env = os.environ.get(ENV_VAR)
    if env is not None:
        return env or None
    return DEFAULT_PATH


def clear_memo() -> None:
    """Drop the memo, so the next read stats the file at once (for a cache
    rewritten in place within `RECHECK_S` or within one mtime granule)."""
    _memo.clear()


def load(path: Optional[str] = None) -> dict:
    """Parsed cache contents ({} when absent, disabled or corrupt: a broken
    cache loses its tuned values and never breaks a search)."""
    if path is None:
        path = cache_path()
    if not path:
        return {}
    now = time.monotonic()
    hit = _memo.get(path)
    if hit is not None and now - hit[2] < RECHECK_S:
        return hit[1]
    try:
        st = os.stat(path)
    except OSError:
        _memo[path] = (None, {}, now)
        return {}
    stamp = (st.st_mtime_ns, st.st_size)
    if hit is not None and hit[0] == stamp:
        _memo[path] = (stamp, hit[1], now)
        return hit[1]
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {}
    if not isinstance(data, dict):
        data = {}
    _memo[path] = (stamp, data, now)
    return data


def lookup(n: int, d: int, *, device,
           path: Optional[str] = None) -> Optional[dict]:
    """The full tuned entry for this point's shape key on ``device``, or
    None."""
    entries = load(path).get("entries")
    if not isinstance(entries, dict):
        return None
    entry = entries.get(space.shape_key(n, d, device))
    return entry if isinstance(entry, dict) else None


def resolved(section: str, n: int, d: int, *, device,
             path: Optional[str] = None) -> Dict[str, Any]:
    """Hand-picked defaults for ``section`` overlaid with the tuned entry
    for this point on ``device`` (only knobs declared in
    `space.HAND_PICKED[section]` are taken from the entry)."""
    out = dict(space.HAND_PICKED[section])
    entry = lookup(n, d, device=device, path=path)
    if entry:
        tuned = entry.get(section)
        if isinstance(tuned, dict):
            out.update({k: v for k, v in tuned.items() if k in out})
    return out


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=_REPO_ROOT, capture_output=True,
            text=True, timeout=10, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _read_for_write(path: str) -> dict:
    """The file's contents, read afresh (not through the memo, which may be
    up to `RECHECK_S` old); {} when it does not exist. A file that exists
    but does not parse raises: a writer must not replace other keys'
    entries with nothing."""
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    if not isinstance(data, dict) or not isinstance(
            data.get("entries", {}), dict):
        raise ValueError(f"tuning cache {path} is not a cache document")
    return data


def save_entry(n: int, d: int, *, device, runtime: Optional[dict] = None,
               build: Optional[dict] = None, serve: Optional[dict] = None,
               trace=None, path: Optional[str] = None) -> str:
    """Write the entry for this point's shape key on ``device`` (the port's
    key: ``cuda-<device name>`` or ``cpu``, then ``torch<version>``),
    stamped with the git commit and a UTC timestamp, and return the key.

    Only that key is added or replaced: every other entry, the JAX
    package's included, is written back as it was read, in the JAX writer's
    layout (``indent=1``, sorted keys), so a JAX entry stays equal parsed and
    as text. The file is written beside its target and renamed into place,
    and the memo is dropped, so the runtime's next lookup sees the entry."""
    if path is None:
        path = cache_path() or DEFAULT_PATH
    key = space.shape_key(n, d, device)
    data = _read_for_write(path)
    data.setdefault("version", 1)
    entries = data.setdefault("entries", {})
    entry: Dict[str, Any] = {
        "key": {"n_bucket": space.n_bucket(n), "d": int(d),
                "platform": space.platform(device),
                "torch_version": torch.__version__},
        "provenance": {
            "commit": _git_sha(),
            "ts": datetime.now(timezone.utc).isoformat(timespec="seconds"),
        },
    }
    for name, section in (("runtime", runtime), ("build", build),
                          ("serve", serve)):
        if section is not None:
            entry[name] = dict(section)
    if trace is not None:
        entry["trace"] = trace
    entries[key] = entry
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    _memo.pop(path, None)
    return key


__all__ = ["ENV_VAR", "DEFAULT_PATH", "RECHECK_S", "cache_path", "clear_memo", "load",
           "lookup", "resolved", "save_entry"]
