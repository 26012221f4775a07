"""The port's host search (`core/search_host.py`), its chi-square and
condition helpers and the paper's metrics against the JAX package, on the
same seeded index and queries (n = 3,000, d = 32).

Held bit for bit: `HostSearcher.search` (the paper's defaults, and with
norm-adaptive radii and Cauchy-Schwarz pruning), `search_progressive`,
`search_incremental` (ids, scores with their dtype, and every `HostStats`
field, the resident page set included) and `btree_key_windows`; the
single-query Quick-Probe (`quick_probe`, `group_lower_bounds`) in its
choice, with the radius and bounds within 1e-6 relative. Within 1e-6
relative: the metrics `overall_ratio` / `recall_at_k`; the chi-square
`condition_b` in equal decisions; `chi2_cdf` and `chi2_ppf` of SciPy's
float64 values, and within 1e-5 of the JAX functions (whose float32
`gammainc` is itself up to 6.4e-6 off at m = 30).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chi2 as jchi2
from repro.core import conditions as jcond
from repro.core import metrics as jmetrics
from repro.core.promips import ProMIPS as JaxProMIPS
from repro.core.search_device import _group_table as jax_group_table
from repro_torch.core import chi2, conditions, metrics
from repro_torch.core.promips import ProMIPS
from repro_torch.core.search_device import _group_table
from repro_torch.data.synthetic import mf_factors

# the modules, not the `quick_probe` functions both `core` packages export
qp = importlib.import_module("repro_torch.core.quick_probe")
jqp = importlib.import_module("repro.core.quick_probe")

BUILD = dict(m=8, c=0.9, p=0.6, k_p=5, k_sp=8, seed=0)
N_Q = 6


@pytest.fixture(scope="module", params=[1, 4], ids=["strata1", "strata4"])
def pair(request):
    x = mf_factors(3000, 32, 8, decay=0.5, norm_tail=0.6, seed=0)
    q = mf_factors(N_Q, 32, 8, decay=0.5, seed=1)
    kw = dict(BUILD, norm_strata=request.param)
    return dict(x=x, q=q, jax=JaxProMIPS.build(x, **kw),
                torch=ProMIPS.build(x, device="cpu", **kw))


def _same(want, got):
    """(ids, scores, HostStats) equal bit for bit, stats field by field."""
    wi, ws, wst = want
    gi, gs, gst = got
    np.testing.assert_array_equal(gi, wi)
    assert gs.dtype == ws.dtype
    np.testing.assert_array_equal(gs.view(np.uint64), ws.view(np.uint64))
    assert vars(gst) == vars(wst)
    assert gst.to_dict() == wst.to_dict()


@pytest.mark.parametrize("opts", [{}, {"norm_adaptive": True},
                                  {"norm_adaptive": True, "cs_prune": True},
                                  {"k": 1}, {"k": 33, "p": 0.9}],
                         ids=["paper", "adaptive", "adaptive-cs", "k1", "k33"])
def test_search_host_bitwise(pair, opts):
    opts = dict({"k": 10}, **opts)
    for q in pair["q"]:
        _same(pair["jax"].search_host(q, **opts),
              pair["torch"].search_host(q, **opts))


@pytest.mark.parametrize("cs_prune", [True, False])
def test_search_host_progressive_bitwise(pair, cs_prune):
    for q in pair["q"]:
        _same(pair["jax"].search_host_progressive(q, k=10, cs_prune=cs_prune),
              pair["torch"].search_host_progressive(q, k=10, cs_prune=cs_prune))


def test_search_incremental_bitwise(pair):
    for q in pair["q"][:3]:
        for k in (1, 10):
            _same(pair["jax"].search_incremental(q, k=k),
                  pair["torch"].search_incremental(q, k=k))


def test_btree_key_windows(pair):
    pair["jax"].search_host(pair["q"][0])          # makes the JAX searcher
    for q in pair["q"]:
        for radius in (0.0, 0.5, 2.0, 50.0):
            assert (pair["torch"].host.btree_key_windows(q, radius)
                    == pair["jax"]._host.btree_key_windows(q, radius))


def test_host_stats_count_pages_and_stops(pair):
    """The host stats are the paper's accounting: a page is counted once,
    and the stop is named."""
    _, _, st = pair["torch"].search_host(pair["q"][0], k=10)
    meta = pair["torch"].meta
    assert 1 <= st.pages <= meta.n_blocks and st.stopped_by in ("A", "B")
    assert st.pages == len(st._resident)
    assert st.to_dict()["queries"] == 1


def test_quick_probe_single_query(pair):
    pm, jpm = pair["torch"], pair["jax"]
    table = _group_table(pm.arrays)
    jtable = jax_group_table(jax.tree.map(jnp.asarray, jpm.index.arrays))
    meta = pm.meta
    rng = np.random.RandomState(3)
    for q in np.concatenate([pair["q"],
                             rng.standard_normal((4, 32)).astype(np.float32)]):
        qt = torch.from_numpy(q)
        q_proj = qt @ pm.arrays.a
        jq_proj = jnp.asarray(q) @ jnp.asarray(jpm.index.arrays.a)
        row, radius, ok = qp.quick_probe(table, q_proj, qt.abs().sum(),
                                         meta.c, meta.x_p)
        jrow, jradius, jok = jqp.quick_probe(jtable, jq_proj,
                                             jnp.abs(jnp.asarray(q)).sum(),
                                             meta.c, meta.x_p)
        assert int(row) == int(jrow) and bool(ok) == bool(jok)
        np.testing.assert_allclose(float(radius), float(jradius), rtol=1e-6)
        lb = qp.group_lower_bounds(table.code, qp.pack_codes(q_proj), q_proj)
        jlb = jqp.group_lower_bounds(jtable.code, jqp.pack_codes(jq_proj),
                                     jq_proj)
        np.testing.assert_allclose(lb.numpy(), np.asarray(jlb), rtol=1e-6,
                                   atol=1e-7)


def test_chi2_cdf_and_ppf():
    """The port's CDF within 1e-6 relative of SciPy's float64 value; the JAX
    package's float32 `gammainc` is itself up to 6.4e-6 relative off it at
    m = 30, so the two packages agree within 1e-5."""
    from scipy.stats import chi2 as sp_chi2
    x = np.concatenate([[-1.0, 0.0], np.linspace(1e-3, 80.0, 200)]).astype(np.float32)
    for m in (1, 8, 16, 30):
        exact = sp_chi2.cdf(x.astype(np.float64), m)
        got = chi2.chi2_cdf(torch.from_numpy(x), m).numpy()
        np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-30)
        want = np.asarray(jchi2.chi2_cdf(jnp.asarray(x), m))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
        p = np.asarray([0.1, 0.5, 0.6, 0.9, 0.99], np.float32)
        got = chi2.chi2_ppf(torch.from_numpy(p), m).numpy()
        exact = [chi2.chi2_ppf_host(float(pv), m) for pv in p]
        np.testing.assert_allclose(got, exact, rtol=1e-6)
        want = np.asarray(jchi2.chi2_ppf(jnp.asarray(p), m))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        for pv in p:
            assert chi2.chi2_ppf_host(float(pv), m) == jchi2.chi2_ppf_host(float(pv), m)


def test_condition_b_chi2_form():
    rng = np.random.RandomState(0)
    n = 400
    proj = rng.uniform(0, 60, n).astype(np.float32)
    best = rng.uniform(-5, 40, n).astype(np.float32)
    best[:5] = -np.inf                                  # an empty top-k
    max_l2sq, q_l2sq = np.float32(30.0), rng.uniform(1, 40, n).astype(np.float32)
    for m, p in ((8, 0.6), (16, 0.9)):
        want = np.asarray(jcond.condition_b(jnp.asarray(proj), jnp.asarray(best),
                                            max_l2sq, jnp.asarray(q_l2sq),
                                            0.9, p, m))
        got = conditions.condition_b(torch.from_numpy(proj), torch.from_numpy(best),
                                     torch.tensor(max_l2sq),
                                     torch.from_numpy(q_l2sq), 0.9, p, m).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < n                       # both outcomes occur
    a = conditions.condition_a(torch.tensor([10.0, 40.0]), torch.tensor(30.0),
                               torch.tensor(5.0), 0.9)
    assert a.tolist() == [False, True]


def test_metrics():
    rng = np.random.RandomState(1)
    for k in (1, 5, 10):
        exact = np.sort(rng.uniform(-1, 5, k))[::-1]
        ret = exact * rng.uniform(0.5, 1.0, k)
        ret[0] = -1.0
        got, want = (metrics.overall_ratio(ret, exact),
                     jmetrics.overall_ratio(ret, exact))
        assert abs(got - want) <= 1e-6 * abs(want)
        ids = rng.choice(50, k, replace=False)
        ex = np.concatenate([ids[: k // 2], rng.choice(np.arange(50, 99), k - k // 2,
                                                       replace=False)])
        assert metrics.recall_at_k(ids, ex) == jmetrics.recall_at_k(ids, ex)
    assert metrics.recall_at_k(np.arange(3), np.arange(0)) == 1.0
