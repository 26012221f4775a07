"""The port's tuning-cache read side (`repro_torch.tune.cache`) against the
JAX package's: a default `RuntimeConfig` resolves ``dense_frac`` and
``tile_cap`` from the cache entry under the port's key, as
`repro.core.runtime.search` does, and a miss resolves the hand-picked
defaults.

Held: ids and every `SearchStats` field equal (radii within 1e-5
relative), to an explicit config with the tuned values and to the JAX
`search_fused.search_batch_fused` called with them. The entry's
``tile_cap`` is below the index's block count, so it truncates the tiles
and the tuned search differs from the hand-picked one. The cache is a
temporary file that ``REPRO_TUNE_CACHE`` points at. The file is stat'ed
at most once every `cache.RECHECK_S` seconds (a clock stands in for time).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import build_index as jax_build_index
from repro.core.search_fused import search_batch_fused as jax_search_fused
from repro.tune import space as jax_space
from repro_torch import api
from repro_torch.convert import index_from_numpy
from repro_torch.core.index import IndexArrays
from repro_torch.core.runtime import RuntimeConfig, search
from repro_torch.data.synthetic import mf_factors
from repro_torch.tune import cache, space

K = 10
BUILD = dict(m=8, c=0.9, p=0.6, k_p=5, k_sp=8, norm_strata=4, seed=0)
SEARCH = dict(k=K, prefilter=True, prefilter_eps=0.3)
TUNED = {"tile_cap": 64, "dense_frac": 0.7}
EXACT = ("pages", "candidates", "probe_passed", "used_round2", "exhausted",
         "rows")


@pytest.fixture(scope="module")
def index():
    x = mf_factors(4000, 48, 12, decay=0.5, norm_tail=0.6, seed=0)
    q = mf_factors(16, 48, 12, decay=0.5, seed=1)
    ref = jax_build_index(x, **BUILD)
    host = {f: np.asarray(getattr(ref.arrays, f)) for f in IndexArrays._fields}
    arrays, meta = index_from_numpy(host, dataclasses.asdict(ref.meta),
                                    device="cpu")
    assert TUNED["tile_cap"] < meta.n_blocks          # the cap truncates
    return dict(x=x, q=q, arrays=arrays, meta=meta, jmeta=ref.meta,
                jarrays=jax.tree.map(jnp.asarray, ref.arrays))


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "tuning.json")
    monkeypatch.setenv(cache.ENV_VAR, path)
    cache.clear_memo()
    yield path
    cache.clear_memo()


def _write(path, entries):
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": entries}, f)
    cache.clear_memo()


def _search(index, **cfg):
    return search(index["arrays"], index["meta"], torch.from_numpy(index["q"]),
                  RuntimeConfig(**SEARCH, **cfg), device="cpu")


def _assert_equal(a, b):
    ids_a, _, st_a = a
    ids_b, _, st_b = b
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b),
                                  err_msg="ids")
    for name in EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(st_a, name)),
                                      np.asarray(getattr(st_b, name)),
                                      err_msg=name)
    for name in ("radius0", "radius1"):
        np.testing.assert_allclose(np.asarray(getattr(st_a, name)),
                                   np.asarray(getattr(st_b, name)),
                                   rtol=1e-5, err_msg=name)


def test_shape_key_names_the_device_and_never_a_jax_key():
    key = space.shape_key(100_000, 128, device="cpu")
    assert key == f"n131072:d128:cpu:torch{torch.__version__}"
    assert space.shape_key(90_000, 128, device="cpu") == key   # one bucket
    jax_key = jax_space.shape_key(100_000, 128, platform="cpu",
                                  jax_version="0.4.37")
    assert key != jax_key and ":jax" not in key and ":torch" not in jax_key


def test_default_runtime_config_reads_the_cache(index, tmp_cache, monkeypatch):
    meta = index["meta"]
    _write(tmp_cache, {space.shape_key(meta.n, meta.d, device="cpu"):
                       {"runtime": dict(TUNED)}})
    assert cache.resolved("runtime", meta.n, meta.d, device="cpu")["tile_cap"] \
        == TUNED["tile_cap"]
    tuned = _search(index)
    _assert_equal(tuned, _search(index, **TUNED))
    assert bool(tuned[2].exhausted.any())             # the cap acted
    nb = meta.n_blocks
    jq = jnp.asarray(index["q"])
    jids, _, jst = jax_search_fused(index["jarrays"], index["jmeta"], jq,
                                    budget=nb, budget2=nb, use_pallas=False,
                                    **SEARCH, **TUNED)
    _assert_equal(tuned, (jids, None, jst))
    # with lookups disabled the hand-picked defaults truncate nothing
    monkeypatch.setenv(cache.ENV_VAR, "")
    assert not bool(_search(index)[2].exhausted.any())


@pytest.mark.parametrize("entries", [
    "absent",
    "jax key",            # the same shape under the JAX package's key
    "other shape",        # another n bucket
    "corrupt",
])
def test_a_cache_miss_gives_the_hand_picked_defaults(index, tmp_cache, entries):
    meta = index["meta"]
    jax_key = jax_space.shape_key(meta.n, meta.d, platform="cpu",
                                  jax_version=jax.__version__)
    other = space.shape_key(4 * meta.n, meta.d, device="cpu")
    if entries == "jax key":
        _write(tmp_cache, {jax_key: {"runtime": dict(TUNED)}})
    elif entries == "other shape":
        _write(tmp_cache, {other: {"runtime": dict(TUNED)}})
    elif entries == "corrupt":
        with open(tmp_cache, "w") as f:
            f.write("{not json")
    assert cache.resolved("runtime", meta.n, meta.d, device="cpu") == \
        space.HAND_PICKED["runtime"]
    _assert_equal(_search(index), _search(index, dense_frac=0.9))


def _rewrite(path, entries):
    """Write the cache without `cache.clear_memo`, as another process would."""
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": entries}, f)


@pytest.fixture
def clock(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(cache.time, "monotonic", lambda: now[0])
    return now


def test_the_cache_file_is_stat_ed_once_a_recheck(tmp_cache, clock,
                                                   monkeypatch):
    """Searches between two rechecks read the memo and stat the file once;
    a rewrite is seen at the next recheck."""
    key = space.shape_key(4000, 48, device="cpu")
    _write(tmp_cache, {key: {"runtime": {"tile_cap": 64}}})
    stats = []
    real_stat = os.stat

    def counting_stat(path, *args, **kwargs):
        stats.append(path)
        return real_stat(path, *args, **kwargs)

    monkeypatch.setattr(cache.os, "stat", counting_stat)

    def tile_cap():
        return cache.resolved("runtime", 4000, 48, device="cpu")["tile_cap"]

    assert [tile_cap() for _ in range(100)] == [64] * 100
    assert stats.count(tmp_cache) == 1
    _rewrite(tmp_cache, {key: {"runtime": {"tile_cap": 128}}})
    clock[0] += 0.5 * cache.RECHECK_S
    assert tile_cap() == 64                           # the memo, no stat
    clock[0] += 0.5 * cache.RECHECK_S
    assert tile_cap() == 128
    assert stats.count(tmp_cache) == 2


def test_a_cache_written_after_a_miss_is_read_at_the_next_recheck(tmp_cache,
                                                                  clock):
    key = space.shape_key(4000, 48, device="cpu")
    assert cache.resolved("runtime", 4000, 48, device="cpu") == \
        space.HAND_PICKED["runtime"]                  # no file yet
    _rewrite(tmp_cache, {key: {"runtime": {"dense_frac": 0.7}}})
    assert cache.resolved("runtime", 4000, 48, device="cpu")["dense_frac"] \
        == space.HAND_PICKED["runtime"]["dense_frac"]
    clock[0] += cache.RECHECK_S
    assert cache.resolved("runtime", 4000, 48, device="cpu")["dense_frac"] \
        == 0.7
    _rewrite(tmp_cache, {key: {"runtime": {"dense_frac": 0.5}}})
    cache.clear_memo()                                # read at once after it
    assert cache.resolved("runtime", 4000, 48, device="cpu")["dense_frac"] \
        == 0.5


def test_facade_and_build_read_the_cache(tmp_cache):
    """`api.build` resolves page_bytes, and the stream adapter its runtime
    knobs, from the entry for the data's shape on the build's device."""
    x = mf_factors(3000, 32, 8, decay=0.5, seed=2)
    _write(tmp_cache, {space.shape_key(len(x), 32, device="cpu"): {
        "build": {"page_bytes": 2048},
        "runtime": {"verification": "batched", "prefilter_eps": 0.2}}})
    searcher = api.build(x, "promips-stream", device="cpu", prefilter=True)
    assert searcher.inner.build_kwargs["page_bytes"] == 2048
    assert searcher.runtime.verification == "batched"
    assert searcher.runtime.prefilter_eps == 0.2
