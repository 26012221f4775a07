"""The port's in-graph fused driver (`search_graph.search_batch_fused_graph`,
its stages run eagerly on the CPU) against the port's host driver
(`search_fused.search_batch_fused`) and against the JAX package's
`repro.core.search_graph.search_batch_fused_graph` (``use_pallas=False``,
under jit) on the same index and queries.

Held against the host driver: ids, scores and every `SearchStats` field
equal bit for bit. Held against JAX: ids, rows, pages, candidates,
probe_passed, used_round2 and exhausted equal, radii and scores within
1e-5 relative (the sums run in other orders in the two frameworks; the
margins this rests on are asserted by `tests/test_torch_search.py` for the
same index). Cases: a full budget (a dense round 1, round 2 over its
cached scores), the prefilter, a truncating budget, a truncating
``tile_cap``, the dense threshold moved, norm-adaptive radii and a batch
whose compensation round is skipped. The device-side tile plan is held
against the host's `_plan_tile` on random masks, and `_tile_buckets`
against the JAX one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search_graph as jax_sg
from repro.core.index import build_index as jax_build_index
from repro_torch.convert import index_from_numpy
from repro_torch.core import search_graph as sg
from repro_torch.core.index import IndexArrays
from repro_torch.core.search_device import search_batch
from repro_torch.core.search_fused import _plan_tile, search_batch_fused
from repro_torch.data.synthetic import mf_factors

# one intra-op thread: the reduced shapes gain nothing from more, and
# beside the other test processes idle threads spin (a reduced train
# run took 25x the CPU time with the default thread count)
torch.set_num_threads(1)

REL = 1e-5
BUILD = dict(m=8, c=0.9, p=0.6, k_p=5, k_sp=8, norm_strata=4, seed=0)
_jax_graph = jax.jit(
    jax_sg.search_batch_fused_graph,
    static_argnames=("meta", "k", "budget", "budget2", "norm_adaptive",
                     "cs_prune", "use_pallas", "prefilter", "prefilter_eps",
                     "dense_frac", "tile_cap"))

# name: (knobs, budget fraction, queries) with "top" = the 16 rows of
# largest norm, whose own row stops most of them by Condition A at k = 1
SETTINGS = {
    "full budget": (dict(k=10), 1.0, "mf"),
    "prefilter 0.3": (dict(k=10, prefilter=True, prefilter_eps=0.3), 1.0, "mf"),
    "truncating budget": (dict(k=10), 0.25, "mf"),
    "tile_cap 16": (dict(k=10, tile_cap=16), 1.0, "mf"),
    "half budget, prefilter 0.3": (dict(k=10, prefilter=True,
                                        prefilter_eps=0.3), 0.5, "mf"),
    "dense_frac 0.05, prefilter 0.1": (dict(k=10, prefilter=True,
                                            prefilter_eps=0.1,
                                            dense_frac=0.05), 1.0, "mf"),
    "norm-adaptive, cs-prune": (dict(k=10, norm_adaptive=True, cs_prune=True,
                                     prefilter=True, prefilter_eps=0.3), 1.0,
                                "mf"),
    "round 2 skipped": (dict(k=1, prefilter=True, prefilter_eps=0.1), 1.0,
                        "top"),
}


@pytest.fixture(scope="module")
def index():
    x = mf_factors(4000, 48, 12, decay=0.5, norm_tail=0.6, seed=0)
    q = mf_factors(16, 48, 12, decay=0.5, seed=1)
    top = x[np.argsort(-np.linalg.norm(x, axis=1))[:16]].copy()
    ref = jax_build_index(x, **BUILD)
    host = {f: np.asarray(getattr(ref.arrays, f)) for f in IndexArrays._fields}
    arrays, meta = index_from_numpy(host, dataclasses.asdict(ref.meta),
                                    device="cpu")
    jarrays = jax.tree.map(jnp.asarray, ref.arrays)
    return dict(x=x, queries=dict(mf=q, top=top), meta=meta, jmeta=ref.meta,
                arrays=arrays, jarrays=jarrays)


def _knobs(index, name):
    knobs, frac, which = SETTINGS[name]
    budget = int(index["meta"].n_blocks * frac)
    return dict(knobs, budget=budget, budget2=budget), index["queries"][which]


@pytest.mark.parametrize("name", list(SETTINGS))
def test_graph_driver_equals_host_driver(index, name):
    knobs, q = _knobs(index, name)
    arrays, meta = index["arrays"], index["meta"]
    qt = torch.from_numpy(q)
    got = sg.search_batch_fused_graph(arrays, meta, qt, **knobs)
    want = search_batch_fused(arrays, meta, qt, **knobs)
    assert torch.equal(got[0], want[0]), "ids"
    assert torch.equal(got[1], want[1]), "scores"
    for field, a, w in zip(want[2]._fields, got[2], want[2]):
        assert a.dtype == w.dtype and torch.equal(a, w), field
    # `search_batch` dispatches "fused" to the graph driver
    via = search_batch(arrays, meta, qt, verification="fused", **knobs)
    assert torch.equal(via[0], got[0]) and torch.equal(via[1], got[1])
    st = want[2]
    if knobs["budget"] < meta.n_blocks or "tile_cap" in knobs:
        assert bool(st.exhausted.any()), "the cap truncated no query"


@pytest.mark.parametrize("name", list(SETTINGS))
def test_graph_driver_matches_jax_graph_driver(index, name):
    knobs, q = _knobs(index, name)
    ids, scores, st = sg.search_batch_fused_graph(
        index["arrays"], index["meta"], torch.from_numpy(q), **knobs)
    jids, jscores, jst = _jax_graph(index["jarrays"], index["jmeta"],
                                    jnp.asarray(q), use_pallas=False, **knobs)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids), err_msg="ids")
    for field in ("rows", "pages", "candidates", "probe_passed", "used_round2",
                  "exhausted"):
        np.testing.assert_array_equal(getattr(st, field).numpy(),
                                      np.asarray(getattr(jst, field)),
                                      err_msg=field)
    for field in ("radius0", "radius1"):
        np.testing.assert_allclose(getattr(st, field).numpy(),
                                   np.asarray(getattr(jst, field)), rtol=REL,
                                   err_msg=field)
    scale = (np.linalg.norm(q, axis=1).max()
             * np.linalg.norm(index["x"], axis=1).max())
    jscores = np.asarray(jscores)
    fin = np.isfinite(jscores)
    np.testing.assert_array_equal(np.isfinite(scores.numpy()), fin)
    np.testing.assert_allclose(scores.numpy()[fin], jscores[fin], rtol=REL,
                               atol=REL * scale, err_msg="scores")


def test_round_2_skipped_case_skips_round_2(index):
    """The "round 2 skipped" batch: round 1 runs, round 2's union is
    empty, so the second stage is the identity (`EMPTY`)."""
    knobs, q = _knobs(index, "round 2 skipped")
    arrays, meta = index["arrays"], index["meta"]
    cfg = sg._Cfg(k=knobs["k"], cap=meta.n_blocks, cap2=meta.n_blocks,
                  norm_adaptive=False, cs_prune=False, on_kernels=False,
                  prefilter=True, prefilter_eps=knobs["prefilter_eps"],
                  min_dense=int(np.ceil(sg.DENSE_FRAC * meta.n_blocks)))
    qt = torch.from_numpy(q)
    fr = sg._frontend(arrays, meta, qt, cfg)
    assert int(fr.plan.choice) != sg.EMPTY
    mid = sg._middle(arrays, meta, qt, fr, int(fr.plan.choice), cfg)
    assert int(mid.choice2) == sg.EMPTY
    assert not bool(mid.mask_r2.any())


# (seed, B, NB, selected share, cap, dense_frac, with a priority)
PLAN_CASES = [
    (0, 5, 300, 0.002, 300, 0.9, False),     # a sparse union, full budget
    (1, 5, 300, 0.3, 300, 0.9, False),       # dense
    (2, 5, 300, 0.3, 40, 0.9, True),         # truncated best-first
    (3, 5, 300, 0.3, 40, 0.9, False),        # truncated in layout order
    (4, 5, 300, 0.0, 300, 0.9, False),       # empty
    (5, 3, 256, 0.01, 256, 0.0325, False),   # the union at the dense cut
    (6, 3, 257, 0.02, 64, 0.5, True),        # union = cap, not dense
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_device_plan_equals_host_plan(case):
    seed, b, nb, share, cap, dense_frac, with_prio = case
    rng = np.random.RandomState(seed)
    mask = rng.rand(b, nb) < share
    if seed == 5:    # exactly ceil(dense_frac * NB) = 9 union blocks
        mask[:] = False
        mask[rng.randint(0, b, 9), rng.choice(nb, 9, replace=False)] = True
    if seed == 6:
        mask[:] = False
        mask[0, rng.choice(nb, cap, replace=False)] = True
    prio = rng.permutation(nb).astype(np.float32) if with_prio else None
    min_dense = int(np.ceil(dense_frac * nb))
    plan = sg._plan(torch.from_numpy(mask),
                    None if prio is None else torch.from_numpy(prio), cap, nb,
                    min_dense)
    want = _plan_tile(mask, cap, nb, dense_frac, prio=prio)
    choice = int(plan.choice)
    if want is None:
        assert choice == sg.EMPTY
        return
    slots, sel, lost, dense = sg._tile(torch.from_numpy(mask), plan.order,
                                       plan.n_keep, choice, cap, nb)
    w_slots, w_sel, w_lost, w_dense = want
    n_keep = int(plan.n_keep)
    assert dense == w_dense and slots.shape[0] == len(w_slots)
    np.testing.assert_array_equal(slots.numpy()[:n_keep], w_slots[:n_keep])
    np.testing.assert_array_equal(sel.numpy(), w_sel)
    np.testing.assert_array_equal(lost.numpy(), w_lost)


def test_tile_buckets_equal_jax():
    for cap in range(1, 301):
        assert sg._tile_buckets(cap) == jax_sg._tile_buckets(cap), cap
