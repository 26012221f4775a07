"""The port's sharded search against the JAX package's, on the CPU.

Held: `build_sharded` gives the JAX arrays and meta in every field on
shards of unequal size, where every padding rule applies (rows and ids -1,
zero-count groups, sub-partition centers at 1e30, padded blocks, zero
codewords); `sharded_search` in fused, batched and progressive mode, with
the prefilter on and off, against the JAX package's own eager reference
(per-shard `runtime.search` on the stacked arrays, merged by `lax.top_k`
over the shard-major concatenation), which `tests/test_distributed.py`
holds equal to the JAX `sharded_search` bit for bit: ids and pages equal,
scores within 1e-5 relative (each package rescores with its own einsum);
fused = batched bit for bit in the port; `MutableShardedProMIPS` under
churn and `compact` against the JAX one (ids and stats equal); the
``sharded`` facade against the JAX facade and its state round trip;
`convert.sharded_from_state` / `sharded_from_dir` on a JAX save; the spans
of a sharded search; and `distributed.fault`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.core import RuntimeConfig as JaxRuntimeConfig
from repro.core.runtime import search as jax_runtime_search
from repro.core.sharded import MutableShardedProMIPS as JaxMutableSharded
from repro.core.sharded import build_sharded as jax_build_sharded
from repro.distributed import fault as jax_dfault
from repro_torch import api
from repro_torch.convert import (sharded_from_dir, sharded_from_state,
                                 stream_from_dir)
from repro_torch.core.runtime import RuntimeConfig
from repro_torch.core.sharded import (MutableShardedProMIPS, build_sharded,
                                      device_put_sharded_index,
                                      sharded_search)
from repro_torch.data.synthetic import mf_factors
from repro_torch.distributed import (ElasticPolicy, StragglerMonitor,
                                     restart_plan)
from repro_torch.obs import trace
from repro_torch.robust import EwmaWatchdog

# one intra-op thread: the reduced shapes gain nothing from more, and
# beside the other test processes idle threads spin (a reduced train
# run took 25x the CPU time with the default thread count)
torch.set_num_threads(1)

REL = 1e-5
K = 10
# 2,881 rows in 3 shards of 960, 960 and 961 rows: at page_rows 32 the last
# shard has one block more, so blocks, codewords (min(256, NB)) and rows
# are padded; the rows of seed 1 give 51, 52 and 54 groups and 960, 960 and
# 961 sub-partitions, so groups and sub-partitions are padded too
N, D, S = 2881, 32, 3
BUILD = dict(m=6, c=0.9, p=0.7, norm_strata=4, seed=0)
CONFIGS = {
    "fused": dict(mode="two_phase", verification="fused",
                  norm_adaptive=True, cs_prune=True),
    "batched": dict(mode="two_phase", verification="batched",
                    norm_adaptive=True, cs_prune=True),
    "fused-prefilter": dict(mode="two_phase", verification="fused",
                            prefilter=True, prefilter_eps=0.3),
    "batched-prefilter": dict(mode="two_phase", verification="batched",
                              prefilter=True, prefilter_eps=0.3),
    "progressive": dict(mode="progressive", cs_prune=True, budget=64),
}


@pytest.fixture
def jax_clean(monkeypatch):
    """`jax.core.trace_state_clean`, which the JAX `runtime.search` asks for
    and this jax lacks, set for one test."""
    monkeypatch.setattr(jax.core, "trace_state_clean", lambda: True,
                        raising=False)


@pytest.fixture(scope="module")
def data():
    x = mf_factors(N, D, 8, decay=0.3, seed=1, norm_tail=0.3)
    q = mf_factors(8, D, 8, decay=0.3, seed=2)
    return x, q


@pytest.fixture(scope="module")
def built(data):
    x, _ = data
    return build_sharded(x, S, **BUILD), jax_build_sharded(x, S, **BUILD)


def _close(got, want):
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert (np.abs(got[fin] - want[fin]) <= REL * np.abs(want[fin]) + 1e-6).all()


def test_build_sharded_matches_jax_with_every_padding_rule(built):
    sh, jsh = built
    assert dataclasses.asdict(sh.meta) == dataclasses.asdict(jsh.meta)
    assert sh.shards == ()
    for name in sh.arrays._fields:
        got, want = getattr(sh.arrays, name), np.asarray(getattr(jsh.arrays, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    a = sh.arrays
    ids_ok = a.ids >= 0
    assert [int(v.sum()) for v in ids_ok] == [960, 960, 961]
    assert (a.ids[~ids_ok] == -1).all() and (a.x[~ids_ok] == 0).all()
    nb = [int(np.any(a.block_sp_idx[s] >= 0, axis=1).sum()) for s in range(S)]
    assert nb == [30, 30, 31]               # shards 0 and 1 carry a padded block
    assert (a.g_count == 0).any()           # zero-count groups
    assert (a.sp_center == np.float32(1e30)).any()
    codewords = [int(np.any(a.sk_codebooks[s] != 0, axis=(0, 2)).sum())
                 for s in range(S)]
    assert min(codewords) < sh.meta.sk_codewords  # zero codewords padded in
    # the global ids: each shard's live ids are its contiguous range
    bounds = np.linspace(0, N, S + 1).astype(int)
    for s in range(S):
        live = np.sort(a.ids[s][ids_ok[s]])
        np.testing.assert_array_equal(live, np.arange(bounds[s], bounds[s + 1]))


def _jax_reference(jsh, q, cfg, k=K):
    """Per-shard `runtime.search` on the stacked arrays + `lax.top_k` over
    the shard-major concatenation (`tests/test_distributed.py`)."""
    ids_all, s_all, pages = [], [], 0
    for s in range(S):
        arrays = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[s]),
                              jsh.arrays)
        i_, sc, st = jax_runtime_search(arrays, jsh.meta,
                                        jnp.asarray(q, jnp.float32),
                                        dataclasses.replace(cfg, k=k))
        ids_all.append(np.asarray(i_))
        s_all.append(np.asarray(sc))
        pages += int(np.sum(np.asarray(st.pages)))
    flat_i = np.concatenate(ids_all, axis=1)
    flat_s = np.concatenate(s_all, axis=1)
    best_s, pos = jax.lax.top_k(jnp.asarray(flat_s), k)
    return (np.take_along_axis(flat_i, np.asarray(pos), axis=1),
            np.asarray(best_s), pages)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_search_matches_jax_reference(data, built, jax_clean, name):
    x, q = data
    sh, jsh = built
    dsh = device_put_sharded_index(sh, "cpu")
    ids, scores, pages = sharded_search(dsh, q, K, device="cpu",
                                        runtime=RuntimeConfig(**CONFIGS[name]))
    w_ids, w_scores, w_pages = _jax_reference(
        jsh, q, JaxRuntimeConfig(**CONFIGS[name]))
    np.testing.assert_array_equal(ids.numpy(), w_ids)
    assert int(pages) == w_pages
    _close(scores.numpy(), w_scores)
    # a host index goes to the device on the call, with the same result
    again = sharded_search(sh, q, K, device="cpu",
                           runtime=RuntimeConfig(**CONFIGS[name]))
    assert torch.equal(again[0], ids) and torch.equal(again[1], scores)


@pytest.mark.parametrize("prefilter", [False, True])
def test_sharded_fused_equals_batched(data, built, prefilter):
    _, q = data
    dsh = device_put_sharded_index(built[0], "cpu")
    cfg = RuntimeConfig(mode="two_phase", verification="fused",
                        norm_adaptive=True, cs_prune=True,
                        prefilter=prefilter, prefilter_eps=0.3)
    fused = sharded_search(dsh, q, K, device="cpu", runtime=cfg)
    batched = sharded_search(dsh, q, K, device="cpu", runtime=dataclasses.replace(
        cfg, verification="batched"))
    for a, b in zip(fused, batched):
        assert torch.equal(a, b)


def test_sharded_search_default_is_progressive(data, built, jax_clean):
    _, q = data
    sh, jsh = built
    ids, _, pages = sharded_search(device_put_sharded_index(sh, "cpu"), q, K,
                                   device="cpu")
    w_ids, _, w_pages = _jax_reference(
        jsh, q, JaxRuntimeConfig(mode="progressive", cs_prune=True, budget=64))
    np.testing.assert_array_equal(ids.numpy(), w_ids)
    assert int(pages) == w_pages


def test_device_put_keeps_one_view_per_shard(built):
    dsh = device_put_sharded_index(built[0], "cpu")
    assert len(dsh.shards) == S
    for s, view in enumerate(dsh.shards):
        for full, part in zip(dsh.arrays, view):
            assert part.is_contiguous()
            assert part.data_ptr() == full[s].data_ptr()
    assert dsh.arrays.g_code.dtype == torch.int64
    assert dsh.arrays.sk_codes.dtype == torch.int32


def _churn(target, rng):
    """Writes on every shard, inserts past the corpus (the last shard's
    append range), updates of base and delta rows, then a compaction."""
    target.insert(np.arange(N, N + 40), rng.randn(40, D).astype(np.float32))
    target.delete(np.array([3, 1000, 2000, 2870, N + 5]))
    target.update(np.array([10, 1500, N + 7]), rng.randn(3, D).astype(np.float32))


def _stats(stats):
    return {k: v for k, v in stats.to_dict().items() if k != "wall_time_s"}


def test_mutable_sharded_matches_jax_under_churn_and_compact(data, jax_clean):
    x, q = data
    kw = dict(BUILD, delta_capacity=128)
    ours = MutableShardedProMIPS(x, S, device="cpu", **kw)
    ref = JaxMutableSharded(x, S, **kw)
    cfg = RuntimeConfig(**CONFIGS["fused-prefilter"])
    jcfg = JaxRuntimeConfig(**CONFIGS["fused-prefilter"])
    for step in ("fresh", "churn", "compact"):
        if step == "churn":
            _churn(ours, np.random.RandomState(2))
            _churn(ref, np.random.RandomState(2))
            assert [len(s.alive_items()[0]) for s in ours.shards] == \
                [len(s.alive_items()[0]) for s in ref.shards]
            # 2000, 2870 and N + 5 are the last shard's
            assert len(ours.shards[-1].alive_items()[0]) == 961 + 40 - 3
        elif step == "compact":
            ours.compact()
            ref.compact()
        ids, scores, stats = ours.search(q, k=K, runtime=cfg)
        w_ids, w_scores, w_stats = ref.search(q, k=K, runtime=jcfg)
        np.testing.assert_array_equal(ids, w_ids, err_msg=step)
        assert _stats(stats) == _stats(w_stats), step
        _close(scores, np.asarray(w_scores))
        assert ours.n_alive == ref.n_alive


def test_sharded_facade_matches_jax_and_round_trips(data, jax_clean):
    x, q = data
    g = api.GuaranteeConfig(c=0.9, p0=0.6, k=K)
    jg = jax_api.GuaranteeConfig(c=0.9, p0=0.6, k=K)
    ours = api.build(x, backend="sharded", guarantee=g, seed=2,
                     page_bytes=4096, n_shards=S, prefilter=True,
                     device="cpu")
    ref = jax_api.build(x, backend="sharded", guarantee=jg, seed=2,
                        page_bytes=4096, n_shards=S, prefilter=True)
    assert isinstance(ours, api.ShardedSearcher)
    assert ours.inner.shards[0].build_kwargs == ref.inner.shards[0].build_kwargs
    assert ours.index_bytes == ref.index_bytes and ours.dim == D
    for rng_seed in (None, 4):
        if rng_seed is not None:
            _churn(ours, np.random.RandomState(rng_seed))
            _churn(ref, np.random.RandomState(rng_seed))
        got, want = ours.search(q), ref.search(q)
        np.testing.assert_array_equal(got.ids, want.ids)
        assert {k: v for k, v in got.stats.items() if k != "wall_time_s"} == \
            {k: v for k, v in want.stats.items() if k != "wall_time_s"}
        _close(got.scores, want.scores)
    g_ids, g_rows = ours.alive_items()
    w_ids, w_rows = ref.alive_items()
    np.testing.assert_array_equal(g_ids, w_ids)
    np.testing.assert_array_equal(g_rows, w_rows)
    assert ours.maintenance_status() == ref.maintenance_status()
    # the state: the JAX arrays and meta, and back through from_state
    arrays, meta = ours.state()
    j_arrays, j_meta = ref.state()
    assert set(arrays) == set(j_arrays)
    for name in arrays:
        np.testing.assert_array_equal(arrays[name], j_arrays[name])
    assert meta == j_meta
    back = api.ShardedSearcher.from_state(arrays, meta, device="cpu")
    np.testing.assert_array_equal(back.search(q).ids, ours.search(q).ids)
    assert back.runtime == ours.runtime


def test_convert_reads_a_jax_sharded_save(data, jax_clean, tmp_path):
    x, q = data
    ref = jax_api.build(x, backend="sharded", seed=1, page_bytes=4096,
                        n_shards=2, m=6)
    _churn(ref, np.random.RandomState(3))
    want = ref.search(q)
    cfg = RuntimeConfig(**{f.name: getattr(ref.runtime, f.name)
                           for f in dataclasses.fields(ref.runtime)
                           if f.name != "use_pallas"})
    for inner in (sharded_from_state(*ref.inner.state_dict(), device="cpu"),
                  sharded_from_dir(ref.save(str(tmp_path / "idx")),
                                   device="cpu")):
        ids, scores, stats = inner.search(q, k=K, runtime=cfg)
        np.testing.assert_array_equal(ids, want.ids)
        assert _stats(stats) == {k: v for k, v in want.stats.items()
                                 if k != "wall_time_s"}
        _close(scores, want.scores)
    with pytest.raises(ValueError, match="saved by backend"):
        stream_from_dir(str(tmp_path / "idx"), device="cpu")


def test_sharded_spans(data, built):
    x, q = data
    dsh = device_put_sharded_index(built[0], "cpu")
    st = MutableShardedProMIPS(x[:600], 2, device="cpu", m=4, seed=0)
    trace.clear()
    cfg = RuntimeConfig(obs=True)
    sharded_search(dsh, q, K, device="cpu", runtime=cfg)
    st.search(q, k=K, runtime=cfg)
    # spans are stored as they end: each shard's ``search`` inside the
    # fan-out, then the stream shards' inside the dispatch, then the merge
    names = [s["name"] for s in trace.spans()]
    i = names.index("sharded_fanout")
    assert names[:i].count("search") == S
    assert names[i + 1:].count("search") == 2
    assert [n for n in names if n.startswith("sharded_")] == [
        "sharded_fanout", "sharded_dispatch", "sharded_merge"]
    assert names[-2:] == ["sharded_dispatch", "sharded_merge"]
    trace.clear()
    sharded_search(dsh, q, K, device="cpu")     # obs off: no span
    assert trace.spans() == []


def test_distributed_fault_matches_jax():
    assert StragglerMonitor is EwmaWatchdog
    for threshold in (2.0, 3.0):
        ours, ref = StragglerMonitor(threshold=threshold), \
            jax_dfault.StragglerMonitor(threshold=threshold)
        for dt in (0.01, 0.012, 0.011, 0.05, 0.02, 0.2):
            assert ours.observe(dt) == ref.observe(dt)
        assert ours.events == ref.events and ours.ewma == ref.ewma
    assert list(restart_plan(7, 12)) == list(jax_dfault.restart_plan(7, 12))
    for mp in (1, 4, 16):
        for n in (1, 2, 3, 4, 6, 8, 12, 16, 32, 64):
            assert (ElasticPolicy(mp).mesh_shape(n)
                    == jax_dfault.ElasticPolicy(mp).mesh_shape(n))
