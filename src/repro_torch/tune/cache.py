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
stat at once. Writing entries waits for the tuner (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

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


__all__ = ["ENV_VAR", "DEFAULT_PATH", "RECHECK_S", "cache_path", "clear_memo", "load",
           "lookup", "resolved"]
