"""The port's span tracer (`repro_torch.obs.trace`) and its spans in the
search stack, on the CPU, against the JAX package's `repro.obs.trace`.

The tracer's own contract, as `tests/test_obs.py` holds the JAX one: the
shared no-op span when off, the ``active=`` override, the bounded ring and
the monotonic total, the ``fenced`` flag, the histogram feed, the Chrome
export's keys, and ``annotate=True`` entering `torch.profiler`'s
`record_function`.

The spans of a search: the same seeded index and queries go through the
port's `runtime.search(obs=True)` (on the CPU, the host driver
`search_batch_fused`) and the JAX `runtime.search(obs=True)`; the span
names come out equal and in the same order, as do the ``fused.*`` round
counters. The same holds for a streaming index's search over a delta and
tombstones (``segments_merge``) and its `compact()` (``stream_compact``).
A search with ``obs=True`` equals the same search with ``obs=False`` bit
for bit in ids, scores and every stats field.

The JAX search needs `jax.core.trace_state_clean` (gone in newer jax): the
`jax_search` fixture sets it through pytest's monkeypatch, which undoes it
at teardown.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import runtime as jax_runtime
from repro.core.index import build_index as jax_build_index
from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro.stream import MutableProMIPS as JaxMutableProMIPS
from repro_torch.convert import index_from_numpy, stream_from_state
from repro_torch.core import runtime
from repro_torch.core.index import IndexArrays
from repro_torch.data.synthetic import mf_factors
from repro_torch.obs import metrics, trace

K = 10
BUILD = dict(m=8, c=0.9, p=0.6, k_p=5, k_sp=8, norm_strata=4, seed=0)
# the default config, and the shipped prefilter knobs
CONFIGS = {"default": dict(), "prefilter": dict(prefilter=True, prefilter_eps=0.1,
                                                dense_frac=0.8)}


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Both packages' tracers off and empty, their registries reset, before
    and after every test."""
    for tr, mt in ((trace, metrics), (jax_trace, jax_metrics)):
        tr.disable()
        tr.clear()
        mt.disable()
        mt.reset()
    yield
    for tr, mt in ((trace, metrics), (jax_trace, jax_metrics)):
        tr.disable()
        tr.clear()
        tr.configure(capacity=8192)
        mt.disable()
        mt.reset()


@pytest.fixture
def jax_search(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", lambda: True,
                        raising=False)


@pytest.fixture(scope="module")
def index():
    x = mf_factors(3000, 32, 10, decay=0.5, norm_tail=0.6, seed=0)
    q = mf_factors(8, 32, 10, decay=0.5, seed=1)
    ref = jax_build_index(x, **BUILD)
    host = {f: np.asarray(getattr(ref.arrays, f)) for f in IndexArrays._fields}
    arrays, meta = index_from_numpy(host, dataclasses.asdict(ref.meta),
                                    device="cpu")
    jarrays = jax.tree.map(jnp.asarray, ref.arrays)
    return dict(x=x, q=q, meta=meta, jmeta=ref.meta, arrays=arrays,
                jarrays=jarrays)


def _names(tr):
    return [s["name"] for s in tr.spans()]


def _round_counters(mt):
    """The fused driver's round-shape counters (the JAX registry also holds
    its jit-retrace gauge, which the port has no counterpart of)."""
    return {name: val for name, val in mt.snapshot().items()
            if name.startswith("fused.rounds_")}


# -- the tracer ---------------------------------------------------------------

def test_disabled_span_is_shared_noop():
    assert trace.span("anything") is trace.span("other")
    assert trace.span("x") is trace._NULL
    with trace.span("x") as sp:
        assert sp.fence(123) == 123
    assert trace.spans() == []


def test_active_override_records_without_global_enable():
    with trace.span("forced", active=True):
        pass
    assert _names(trace) == ["forced"]
    # and active=False forces the no-op even when globally enabled
    trace.enable()
    assert trace.span("y", active=False) is trace._NULL


def test_ring_is_bounded_and_total_is_monotonic():
    trace.configure(capacity=4)
    trace.enable()
    t0 = trace.total()
    for i in range(10):
        with trace.span(f"s{i}"):
            pass
    assert _names(trace) == ["s6", "s7", "s8", "s9"]
    assert trace.total() == t0 + 10
    trace.clear()
    assert trace.spans() == [] and trace.total() == t0 + 10
    with pytest.raises(ValueError):
        trace.configure(capacity=0)


def test_fence_records_flag_and_returns_value():
    t = torch.arange(4.0)
    trace.enable(fence=True)
    assert trace.fencing()
    with trace.span("fenced_one") as sp:
        out = sp.fence(t)
    assert out is t
    with trace.span("fenced_nest") as sp:
        nest = (t, {"a": [t]})
        assert sp.fence(nest) is nest
    assert [s["fenced"] for s in trace.spans()] == [True, True]
    trace.disable()
    trace.enable(fence=False)
    with trace.span("unfenced") as sp:
        sp.fence(t)
    with trace.span("nothing_to_fence"):
        pass
    assert [s["fenced"] for s in trace.spans()[-2:]] == [False, False]


def test_span_feeds_declared_histogram():
    with trace.span("x", active=True, metric="search.batch_us"):
        pass
    assert metrics.snapshot()["search.batch_us"]["count"] == 1
    with pytest.raises(ValueError, match="undeclared"):
        with trace.span("y", active=True, metric="search.made_up"):
            pass


def test_export_chrome_trace(tmp_path):
    trace.enable()
    with trace.span("alpha"):
        with trace.span("beta"):
            pass
    path = trace.export_chrome_trace(str(tmp_path / "sub" / "trace.json"))
    doc = json.load(open(path))
    assert set(doc) >= {"traceEvents", "displayTimeUnit"}
    assert doc["otherData"]["span_count"] == 2
    assert [e["name"] for e in doc["traceEvents"]] == ["beta", "alpha"]
    for e in doc["traceEvents"]:
        assert e["ph"] == "X" and "ts" in e and "dur" in e
        assert e["dur"] >= 0 and e["tid"] == 0
        assert e["args"]["fenced"] is False


def test_annotate_enters_record_function():
    trace.enable(annotate=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("annotated_span"):
            torch.ones(8).sum()
    assert "annotated_span" in {e.key for e in prof.key_averages()}
    assert _names(trace) == ["annotated_span"]


# -- spans in the search stack ------------------------------------------------

def _search_both(index, config):
    kw = dict(CONFIGS[config], k=K, obs=True)
    q = index["q"]
    ours = runtime.search(index["arrays"], index["meta"], torch.from_numpy(q),
                          runtime.RuntimeConfig(**kw), device="cpu")
    ref = jax_runtime.search(index["jarrays"], index["jmeta"], jnp.asarray(q),
                             jax_runtime.RuntimeConfig(**kw))
    return ours, ref


@pytest.mark.parametrize("config", list(CONFIGS))
def test_search_spans_equal_jax_in_name_and_order(index, jax_search, config):
    (ids, _, _), (jids, _, _) = _search_both(index, config)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    names = _names(trace)
    assert names == _names(jax_trace)
    inner = (["select_frontend", "plan_tile_round1", "verify_round1",
              "compensation", "plan_tile_round2", "verify_round2"]
             if config == "default" else
             ["select_frontend", "prefilter_round1", "plan_tile_round1",
              "verify_round1", "compensation", "prefilter_round2",
              "plan_tile_round2", "verify_round2"])
    assert names == inner + ["rescore", "search"]
    assert _round_counters(metrics) == _round_counters(jax_metrics) != {}
    snap = metrics.snapshot()
    assert snap["search.batch_us"]["count"] == 1
    assert snap["search.verify_round_us"]["count"] == 2


def test_global_switch_records_and_obs_false_does_not(index):
    q = torch.from_numpy(index["q"])
    cfg = runtime.RuntimeConfig(k=K)
    runtime.search(index["arrays"], index["meta"], q, cfg, device="cpu")
    assert trace.spans() == []
    trace.enable(fence=True)
    runtime.search(index["arrays"], index["meta"], q, cfg, device="cpu")
    assert _names(trace)[-2:] == ["rescore", "search"]
    assert all(s["fenced"] for s in trace.spans()
               if s["name"] not in ("plan_tile_round1", "plan_tile_round2"))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_obs_on_and_off_are_bit_identical(index, config):
    q = torch.from_numpy(index["q"])
    out = []
    for obs in (False, True):
        trace.enable(fence=obs)
        out.append(runtime.search(index["arrays"], index["meta"], q,
                                  runtime.RuntimeConfig(k=K, obs=obs,
                                                        **CONFIGS[config]),
                                  device="cpu"))
    (i0, s0, st0), (i1, s1, st1) = out
    assert torch.equal(i0, i1) and torch.equal(s0, s1)
    for field, a, b in zip(st0._fields, st0, st1):
        assert torch.equal(a, b), field


def test_runtime_config_obs_validation():
    assert runtime.RuntimeConfig(obs=True).obs is True
    with pytest.raises(ValueError, match="obs"):
        runtime.RuntimeConfig(obs=1)


def test_stream_spans_equal_jax(jax_search):
    x = mf_factors(1600, 32, 10, decay=0.5, norm_tail=0.6, seed=0)
    q = mf_factors(6, 32, 10, decay=0.5, seed=1)
    new = mf_factors(200, 32, 10, decay=0.5, norm_tail=0.6, seed=3)
    arrays, meta = JaxMutableProMIPS(x, **BUILD).state_dict()
    jst = JaxMutableProMIPS.from_state(arrays, meta)
    tst = stream_from_state(arrays, meta, device="cpu")
    for st in (jst, tst):
        st.insert(np.arange(len(x), len(x) + len(new)), new)
        st.delete(np.arange(0, 60, 3))
    cfg = dict(prefilter=True, prefilter_eps=0.1, dense_frac=0.8)
    off = tst.search(q, k=K, runtime=runtime.RuntimeConfig(**cfg))
    on = tst.search(q, k=K, runtime=runtime.RuntimeConfig(obs=True, **cfg))
    jst.search(q, k=K, runtime=jax_runtime.RuntimeConfig(obs=True, **cfg))
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    assert off[2].to_dict() == on[2].to_dict()
    names = _names(trace)
    assert names == _names(jax_trace)
    assert names[-3:] == ["rescore", "search", "segments_merge"]
    trace.clear()
    jax_trace.clear()
    trace.enable()
    jax_trace.enable()
    for st in (jst, tst):
        st.compact()
    assert _names(trace) == _names(jax_trace) == ["stream_compact"]
    # the metrics registry alone switches the compaction span on too
    trace.disable()
    metrics.enable()
    tst.delete([1])
    tst.compact()
    assert _names(trace) == ["stream_compact", "stream_compact"]
    assert metrics.snapshot()["stream.compaction_us"]["count"] == 2
