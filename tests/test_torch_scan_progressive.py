"""The port's scan verification and progressive search (their plain path,
on the CPU) against the jitted JAX `search_device.search_batch(...,
verification="scan")` and `search_batch_progressive`, on the same index and
queries (n = 4,000, d = 32, NB = 125).

Held at full budget, at a budget that truncates most queries' walks and at
budget 1, for k in {1, 10, 33}, with the sketch prefilter on and off (scan)
and with the paper's radii and the norm-adaptive radii with Cauchy-Schwarz
pruning: ids, rows, pages, candidates, used_round2, exhausted and
probe_passed equal, scores within 1e-5 relative (+1e-6). Inside the port,
at full budget, scan = batched = fused in ids, rows, pages, candidates,
used_round2 and exhausted. `runtime.search` in both modes against the JAX
`runtime.search` (its `jax.core.trace_state_clean`, gone from this jax, is
set through monkeypatch). The module first asserts the precondition those
equalities rest on: no score within 1e-5 relative of c_half and no two of
a query's top 34 scores (k + 1 at the largest k) within 1e-5 relative of
each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import runtime as jax_runtime
from repro.core import search_device as jax_sd
from repro.core.index import build_index as jax_build_index
from repro_torch.convert import index_from_numpy
from repro_torch.core import search_device as sd
from repro_torch.core.index import IndexArrays
from repro_torch.core.runtime import RuntimeConfig, search
from repro_torch.data.synthetic import mf_factors

# one intra-op thread: the reduced shapes gain nothing from more, and
# beside the other test processes idle threads spin (a reduced train
# run took 25x the CPU time with the default thread count)
torch.set_num_threads(1)

REL = 1e-5
BUILD = dict(m=8, c=0.9, p=0.6, k_p=5, k_sp=8, norm_strata=4, seed=0)
STATS = ("rows", "pages", "candidates", "used_round2", "exhausted",
         "probe_passed")


@pytest.fixture(scope="module")
def index():
    x = mf_factors(4000, 32, 8, decay=0.5, norm_tail=0.6, seed=0)
    q = mf_factors(16, 32, 8, decay=0.5, seed=1)
    ref = jax_build_index(x, **BUILD)
    host = {f: np.asarray(getattr(ref.arrays, f)) for f in IndexArrays._fields}
    arrays, meta = index_from_numpy(host, dataclasses.asdict(ref.meta),
                                    device="cpu")
    return dict(x=x, q=q, host=host, meta=meta, jmeta=ref.meta, arrays=arrays,
                jarrays=jax.tree.map(jnp.asarray, ref.arrays))


def _budget(meta, which):
    return {"full": meta.n_blocks, "truncating": meta.n_blocks // 12,
            "one": 1}[which]


def _assert_same(got, want):
    ids, scores, st = got
    jids, jscores, jst = want
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    for name in STATS:
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    jscores = np.asarray(jscores)
    fin = np.isfinite(jscores)
    np.testing.assert_array_equal(np.isfinite(scores.numpy()), fin)
    assert (np.abs(scores.numpy()[fin] - jscores[fin])
            <= REL * np.abs(jscores[fin]) + 1e-6).all()


def test_precondition_no_score_at_a_cut(index):
    x, q, host, meta = index["x"], index["q"], index["host"], index["meta"]
    s = q.astype(np.float64) @ x.T.astype(np.float64)
    c_half = 0.5 * meta.c * (np.float64(host["max_l2sq"])
                             + (q.astype(np.float64) ** 2).sum(1))
    assert (np.abs(s - c_half[:, None]) > REL * np.abs(c_half[:, None])).all()
    top = -np.sort(-s, axis=1)[:, :34]
    assert (-np.diff(top, axis=1) > REL * np.abs(top[:, 1:])).all()


@pytest.mark.parametrize("radii", ["paper", "adaptive-cs"])
@pytest.mark.parametrize("prefilter", [False, True], ids=["plain", "prefilter"])
@pytest.mark.parametrize("k", [1, 10, 33])
@pytest.mark.parametrize("which", ["full", "truncating", "one"])
def test_scan_matches_jax(index, which, k, prefilter, radii):
    meta, q = index["meta"], index["q"]
    budget = _budget(meta, which)
    adaptive = radii == "adaptive-cs"
    knobs = dict(k=k, budget=budget, budget2=budget, norm_adaptive=adaptive,
                 cs_prune=adaptive, prefilter=prefilter, prefilter_eps=0.5)
    got = sd.search_batch(index["arrays"], meta, torch.from_numpy(q),
                          verification="scan", **knobs)
    want = jax_sd.search_batch(index["jarrays"], index["jmeta"], jnp.asarray(q),
                               verification="scan", **knobs)
    _assert_same(got, want)
    if which == "truncating":
        assert got[2].exhausted.float().mean() > 0.5, "the budget truncated few"


@pytest.mark.parametrize("cs_prune", [True, False])
@pytest.mark.parametrize("k", [1, 10, 33])
@pytest.mark.parametrize("which", ["full", "truncating", "one"])
def test_progressive_matches_jax(index, which, k, cs_prune):
    meta, q = index["meta"], index["q"]
    budget = _budget(meta, which)
    got = sd.search_batch_progressive(index["arrays"], meta, torch.from_numpy(q),
                                      k=k, budget=budget, cs_prune=cs_prune)
    want = jax_sd.search_batch_progressive(index["jarrays"], index["jmeta"],
                                           jnp.asarray(q), k=k, budget=budget,
                                           cs_prune=cs_prune)
    _assert_same(got, want)
    if which == "full":
        assert not got[2].exhausted.any()
    else:
        assert got[2].exhausted.any()


@pytest.mark.parametrize("prefilter", [False, True], ids=["plain", "prefilter"])
@pytest.mark.parametrize("k", [1, 10, 33])
def test_full_budget_scan_equals_batched_and_fused(index, k, prefilter):
    """At full budget the three backends walk the same blocks to the same
    stop: equal ids, rows, pages, candidates, used_round2 and exhausted."""
    meta, q = index["meta"], torch.from_numpy(index["q"])
    knobs = dict(k=k, budget=meta.n_blocks, budget2=meta.n_blocks,
                 norm_adaptive=True, cs_prune=True, prefilter=prefilter,
                 prefilter_eps=0.5)
    scan = sd.search_batch(index["arrays"], meta, q, verification="scan",
                           **knobs)
    for other in ("batched", "fused"):
        ids, scores, st = sd.search_batch(index["arrays"], meta, q,
                                          verification=other, **knobs)
        assert torch.equal(ids, scan[0]), other
        for name in STATS:
            assert torch.equal(getattr(st, name), getattr(scan[2], name)), (
                other, name)
        torch.testing.assert_close(scores, scan[1], rtol=REL, atol=1e-6)


@pytest.fixture
def jax_search(monkeypatch):
    """The JAX `runtime.search`, with the `jax.core.trace_state_clean` it
    asks for (gone from this jax) set for this test only."""
    monkeypatch.setattr(jax.core, "trace_state_clean", lambda: True,
                        raising=False)
    return jax_runtime.search


@pytest.mark.parametrize("mode", ["progressive", "scan"])
@pytest.mark.parametrize("budget", [None, 10])
def test_runtime_modes_match_jax(index, jax_search, mode, budget):
    meta, q = index["meta"], index["q"]
    knobs = dict(k=10, budget=budget, cs_prune=True)
    if mode == "progressive":
        cfg = RuntimeConfig(mode="progressive", **knobs)
        jcfg = jax_runtime.RuntimeConfig(mode="progressive", **knobs)
    else:
        cfg = RuntimeConfig(verification="scan", norm_adaptive=True, **knobs)
        jcfg = jax_runtime.RuntimeConfig(verification="scan", norm_adaptive=True,
                                         **knobs)
    got = search(index["arrays"], meta, q, cfg, device="cpu")
    want = jax_search(index["jarrays"], index["jmeta"], jnp.asarray(q), jcfg)
    _assert_same(got, want)


def test_runtime_refuses_the_prefilter_in_progressive_mode(index):
    cfg = RuntimeConfig(mode="progressive", prefilter=True)
    with pytest.raises(ValueError, match="two_phase"):
        search(index["arrays"], index["meta"], index["q"], cfg, device="cpu")
