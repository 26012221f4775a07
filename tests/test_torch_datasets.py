"""The paper's four dataset proxies in the port (`repro_torch.data.synthetic`:
`DATASETS`, `paper_dataset`, `paper_queries`) and the quickstart's flow
through the port's facade, against the JAX package on the CPU.

Held: `DATASETS` equal to the JAX dict; every name's corpus and queries
equal bit for bit at its scaled size; on the Netflix proxy cut to its first
4,000 rows (the `tests/test_system.py` cut), the derived plan equal and each
backend of the quickstart's sweep returning the JAX facade's ids, with
scores within 1e-5 relative; the quickstart example itself (the port's,
`examples/quickstart_torch.py`) runs on the CPU and reports a bit-identical
save / load round trip.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest

from repro import api as jax_api
from repro.data import synthetic as jax_synthetic
from repro_torch import api
from repro_torch.data import synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GUARANTEE = dict(c=0.9, p0=0.5, k=10)
SWEEP = (("promips", dict(m=6)), ("promips", dict(m=6, mode="progressive")),
         ("h2alsh", {}), ("rangelsh", {}), ("pq", dict(n_cells=32)))


@pytest.fixture
def jax_clean(monkeypatch):
    """`jax.core.trace_state_clean`, which the JAX `runtime.search` asks for
    and this jax lacks, set for one test."""
    monkeypatch.setattr(jax.core, "trace_state_clean", lambda: True,
                        raising=False)


def test_datasets_table_equals_jax():
    assert synthetic.DATASETS == jax_synthetic.DATASETS
    assert list(synthetic.DATASETS) == ["netflix", "yahoo", "p53", "sift"]


@pytest.mark.parametrize("name", ["netflix", "yahoo", "p53", "sift"])
def test_paper_dataset_and_queries_bit_for_bit(name):
    x = synthetic.paper_dataset(name)
    want = jax_synthetic.paper_dataset(name)
    cfg = synthetic.DATASETS[name]
    assert x.shape == (cfg["scaled_n"], cfg["d"]) and x.dtype == np.float32
    assert np.array_equal(x.view(np.int32), want.view(np.int32))
    del x, want
    for n_q, seed in ((100, 1), (64, 1), (16, 5)):
        q = synthetic.paper_queries(name, n_q, seed=seed)
        jq = jax_synthetic.paper_queries(name, n_q, seed=seed)
        assert q.shape == (n_q, cfg["d"])
        assert np.array_equal(q.view(np.int32), jq.view(np.int32))
    if name == "sift":
        assert (synthetic.paper_queries(name, 8) >= 0).all()


@pytest.fixture(scope="module")
def netflix():
    return (synthetic.paper_dataset("netflix")[:4000],
            synthetic.paper_queries("netflix", 12))


def test_quickstart_plan_equals_jax(netflix):
    x, _ = netflix
    plan = api.GuaranteeConfig(**GUARANTEE).derive(len(x))
    want = jax_api.GuaranteeConfig(**GUARANTEE).derive(len(x))
    assert (plan.m, plan.x_p, plan.probe_cost, plan.budget) == (
        want.m, want.x_p, want.probe_cost, want.budget)


@pytest.mark.parametrize("backend,opts", SWEEP,
                         ids=[b + ("+" if o.get("mode") else "")
                              for b, o in SWEEP])
def test_quickstart_sweep_equals_jax_facade(netflix, jax_clean, backend,
                                            opts):
    x, q = netflix
    s = api.build(x, backend=backend, guarantee=api.GuaranteeConfig(
        **GUARANTEE), seed=0, device="cpu", **opts)
    js = jax_api.build(x, backend=backend, guarantee=jax_api.GuaranteeConfig(
        **GUARANTEE), seed=0, **opts)
    res, want = s.search(q), js.search(q)
    np.testing.assert_array_equal(res.ids, want.ids)
    scale = np.abs(want.scores).max(axis=1, keepdims=True)
    assert np.all(np.abs(res.scores - want.scores) <= 1e-5 * scale)
    assert res.pages == want.pages
    assert s.index_bytes == js.index_bytes


def test_quickstart_example_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(ROOT, "examples",
                                         "quickstart_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--n", "4000"]) is True
    out = capsys.readouterr().out
    assert "bit-identical=True" in out
    assert out.count("guaranteed=") == len(SWEEP)
