"""The port's streaming index (plain path, on the CPU) against the JAX
package's `repro.stream.MutableProMIPS`: the same seeded corpus, the same
inserts, deletes and updates, the same queries.

Held in every state: ids, pages, candidates and exhausted equal; scores
within 1e-5 relative to |q| |x|, with the returned neighbours of each query
more than 1e-5 apart (the precondition under which GEMMs summed in two
orders return the same ids). The states: clean; delta only; tombstones with
an over-fetch k_base above 1,024; after `compact()` (base arrays
bit-identical to the JAX package's compacted base, search equal to a cold
build); a background compaction with writes landing while it runs; and the
JAX state carried across (`convert.stream_from_state`, `stream_from_dir`).

The JAX stream searches through `runtime.search`, which needs
`jax.core.trace_state_clean` (gone in newer jax): the `jax_search` fixture
sets it through pytest's monkeypatch, which undoes it at teardown.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api
from repro.core.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.stream import MutableProMIPS as JaxMutableProMIPS
from repro.stream.compaction import Compactor as JaxCompactor
from repro_torch.convert import stream_from_dir, stream_from_state
from repro_torch.core.index import IndexArrays
from repro_torch.core.promips import ProMIPS
from repro_torch.core.runtime import RuntimeConfig
from repro_torch.data.synthetic import mf_factors
from repro_torch.stream import Compactor, MutableProMIPS, rebuild_base

# one intra-op thread: the reduced shapes gain nothing from more, and
# beside the other test processes idle threads spin (a reduced train
# run took 25x the CPU time with the default thread count)
torch.set_num_threads(1)

K = 10
REL = 1e-5
N, D, RANK = 2400, 48, 12
BUILD = dict(m=8, c=0.9, p=0.6, k_p=5, k_sp=8, norm_strata=4, seed=0)
# the default config, and the shipped prefilter knobs
CONFIGS = {"default": dict(), "prefilter": dict(prefilter=True, prefilter_eps=0.1,
                                                dense_frac=0.8)}


@pytest.fixture
def jax_search(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", lambda: True,
                        raising=False)


@pytest.fixture(scope="module")
def corpus():
    x = mf_factors(N, D, RANK, decay=0.5, norm_tail=0.6, seed=0)
    q = mf_factors(16, D, RANK, decay=0.5, seed=1)
    new = mf_factors(600, D, RANK, decay=0.5, norm_tail=0.6, seed=3)
    state = JaxMutableProMIPS(x, **BUILD).state_dict()
    return dict(x=x, q=q, new=new, state=state)


def _streams(corpus):
    """A JAX stream and the port's, both restored from one JAX state."""
    arrays, meta = corpus["state"]
    return (JaxMutableProMIPS.from_state(arrays, meta),
            stream_from_state(arrays, meta, device="cpu"))


def _search_both(jst, tst, q, config="default"):
    kw = CONFIGS[config]
    ji, js, jstats = jst.search(q, k=K, runtime=JaxRuntimeConfig(**kw))
    ti, ts, tstats = tst.search(q, k=K, runtime=RuntimeConfig(**kw))
    return (ti, ts, tstats), (ji, js, jstats)


def _assert_same(ours, ref, q, x):
    (ti, ts, tstats), (ji, js, jstats) = ours, ref
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg="ids")
    for name in ("pages", "candidates", "exhausted"):
        np.testing.assert_array_equal(getattr(tstats, name).numpy(),
                                      np.asarray(getattr(jstats, name)),
                                      err_msg=name)
    assert tstats.to_dict() == jstats.to_dict()
    scale = np.linalg.norm(q, axis=1).max() * np.linalg.norm(x, axis=1).max()
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=REL,
                               atol=REL * scale, err_msg="scores")
    got = ts.numpy().astype(np.float64)
    finite = np.isfinite(got[:, 1:])
    gap = (got[:, :-1] - got[:, 1:])[finite]
    assert (gap > REL * np.abs(got[:, 1:][finite])).all(), \
        "precondition: two returned neighbours within 1e-5 relative"


def _write(streams, op, *args):
    for st in streams:
        getattr(st, op)(*args)


def _exact_recall(st, q):
    gids, rows = st.alive_items()
    s = q.astype(np.float64) @ rows.T.astype(np.float64)
    want = gids[np.argsort(-s, axis=1, kind="stable")[:, :K]]
    ids = st.search(q, k=K)[0].numpy()
    return np.mean([len(set(ids[b]) & set(want[b])) / K for b in range(len(q))])


def test_clean_stream_equals_jax_and_the_static_search(corpus, jax_search):
    x, q = corpus["x"], corpus["q"]
    jst = JaxMutableProMIPS(x, **BUILD)
    tst = MutableProMIPS(x, device="cpu", **BUILD)
    for name in IndexArrays._fields:
        np.testing.assert_array_equal(getattr(tst._base.arrays, name),
                                      np.asarray(getattr(jst._base.arrays, name)),
                                      err_msg=name)
    assert tst.snapshot().clean
    ours, ref = _search_both(jst, tst, q, "prefilter")
    _assert_same(ours, ref, q, x)
    # the clean route is the static search on the base, bit for bit
    pm = ProMIPS(tst._base, device="cpu")
    ids, scores, _ = pm.search(q, k=K, **CONFIGS["prefilter"])
    assert torch.equal(ids, ours[0]) and torch.equal(scores, ours[1])


@pytest.mark.parametrize("config", list(CONFIGS))
def test_delta_only_equals_jax(corpus, jax_search, config):
    jst, tst = _streams(corpus)
    _write((jst, tst), "insert", np.arange(50_000, 50_300), corpus["new"][:300])
    assert tst.snapshot().n_base_dead == 0 and tst.snapshot().delta_count == 300
    ours, ref = _search_both(jst, tst, corpus["q"], config)
    _assert_same(ours, ref, corpus["q"], corpus["x"])
    assert (ours[0].numpy() >= 50_000).any()          # delta rows are found


@pytest.mark.parametrize("config", list(CONFIGS))
def test_tombstones_with_over_fetch_beyond_1024_equals_jax(corpus, jax_search,
                                                           config):
    """700 base deletes and 50 base updates: k_base = 10 + next_pow2(750)
    = 1034, above the CUDA kernel's shared-memory merge. The queries' exact
    top-20 base rows are among the deleted, so the masking decides ids."""
    x, q = corpus["x"], corpus["q"]
    jst, tst = _streams(corpus)
    _write((jst, tst), "insert", np.arange(50_000, 50_200), corpus["new"][:200])
    top = np.argsort(-(q @ x.T), axis=1)[:, :20]
    rng = np.random.RandomState(4)
    rest = np.setdiff1d(np.arange(N), top)
    dead = np.union1d(top, rng.choice(rest, 700 - len(np.unique(top)),
                                      replace=False))
    _write((jst, tst), "delete", dead)
    upd = rng.choice(np.setdiff1d(np.arange(N), dead), 50, replace=False)
    _write((jst, tst), "update", upd, corpus["new"][200:250])
    _write((jst, tst), "delete", np.arange(50_000, 50_020))
    snap = tst.snapshot()
    assert snap.n_base_dead == 750
    assert K + (1 << (snap.n_base_dead - 1).bit_length()) == 1034
    ours, ref = _search_both(jst, tst, q, config)
    _assert_same(ours, ref, q, x)
    assert not np.isin(ours[0].numpy(), np.concatenate([dead, np.arange(50_000, 50_020)])).any()
    assert _exact_recall(tst, q) == 1.0


def test_compaction_equals_jax_and_a_cold_build(corpus, jax_search):
    x, q = corpus["x"], corpus["q"]
    jst, tst = _streams(corpus)
    rng = np.random.RandomState(6)
    _write((jst, tst), "insert", np.arange(60_000, 60_400), corpus["new"][:400])
    _write((jst, tst), "delete", rng.choice(N, 300, replace=False))
    _write((jst, tst), "update", np.arange(60_000, 60_050), corpus["new"][400:450])
    gids, rows = tst.alive_items()
    _write((jst, tst), "compact")
    assert tst.churn_fraction == 0.0 and tst.n_alive == len(gids)
    for name in IndexArrays._fields:
        np.testing.assert_array_equal(getattr(tst._base.arrays, name),
                                      np.asarray(getattr(jst._base.arrays, name)),
                                      err_msg=name)
    assert dataclasses.asdict(tst.meta) == dataclasses.asdict(jst.meta)
    ours, ref = _search_both(jst, tst, q, "prefilter")
    _assert_same(ours, ref, q, x)
    cold = ProMIPS(rebuild_base(gids, rows, dict(BUILD)), device="cpu")
    ids, scores, _ = cold.search(q, k=K, **CONFIGS["prefilter"])
    assert torch.equal(ids, ours[0]) and torch.equal(scores, ours[1])


def test_background_compaction_with_concurrent_writes_equals_jax(corpus,
                                                                  jax_search):
    """The stream's lock is held from the freeze until the writes are in,
    so they land while the rebuild is in flight (the install waits for the
    lock) and are replayed onto the new base; searches run between them."""
    x, q = corpus["x"], corpus["q"]
    streams = _streams(corpus)
    jst, tst = streams
    _write(streams, "insert", np.arange(70_000, 70_300), corpus["new"][:300])
    _write(streams, "delete", np.arange(0, 400, 2))
    for st, compactor in ((jst, JaxCompactor()), (tst, Compactor())):
        st.compactor = compactor
        with st._lock:
            compactor.start(st)
            assert st._oplog is not None
            for i in range(4):
                lo = 70_300 + 50 * i
                st.insert(np.arange(lo, lo + 50), corpus["new"][300 + 50 * i:
                                                               350 + 50 * i])
                st.search(q, k=K)
            st.delete(np.arange(1, 41, 2))
            assert len(st._oplog) == 5
        st.join_compaction(timeout=120)
        assert not compactor.in_flight and compactor.runs == 1
    assert tst._delta.count == 200 and tst.meta.n == N + 300 - 200
    ours, ref = _search_both(jst, tst, q, "prefilter")
    _assert_same(ours, ref, q, x)
    assert set(np.arange(70_300, 70_500)) <= set(tst.alive_items()[0].tolist())
    assert _exact_recall(tst, q) == 1.0


def test_state_carried_across_both_ways(corpus, jax_search, tmp_path):
    x, q = corpus["x"], corpus["q"]
    jst, tst = _streams(corpus)
    _write((jst, tst), "insert", np.arange(80_000, 80_100), corpus["new"][:100])
    _write((jst, tst), "delete", np.arange(10, 30))
    # JAX state -> the port
    port = stream_from_state(*jst.state_dict(), device="cpu")
    ours, ref = _search_both(jst, port, q)
    _assert_same(ours, ref, q, x)
    # the port's state -> JAX: the same layout and keys
    ta, tm = tst.state_dict()
    ja, jm = jst.state_dict()
    assert ta.keys() == ja.keys() and tm == jm
    for key in ta:
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)
    back = JaxMutableProMIPS.from_state(ta, tm)
    ours, ref = _search_both(back, tst, q)
    _assert_same(ours, ref, q, x)
    # a promips-stream save directory
    saved = api.build(x[:800], backend="promips-stream", seed=0)
    saved.insert(np.arange(90_000, 90_050), corpus["new"][:50])
    saved.delete(np.arange(0, 20))
    path = saved.save(str(tmp_path / "stream"))
    loaded = stream_from_dir(path, device="cpu")
    ours, ref = _search_both(saved.inner, loaded, q)
    _assert_same(ours, ref, q, x)
    with pytest.raises(ValueError):
        stream_from_dir(api.build(x[:800], backend="promips", seed=0)
                        .save(str(tmp_path / "static")), device="cpu")
