"""The port's autotuner (`repro_torch.tune`: `cutout`, `search`, the CLI and
`cache.save_entry`) against the JAX package's `repro.tune`, on the CPU.

Held:
- `make_cutout` equal to the JAX one bit for bit (several seeds and shapes,
  and the LARGE_N shape);
- `round1_union`, the planned round-1 ``_tile`` record and
  `_tile_cap_candidates` equal to the JAX cutout's, on an index the JAX
  package built and `convert.py` carried across;
- `tune_point` at the JAX smoke size (1,500 x 24, 8 queries, budget 30 s):
  every candidate has a status, the winner reproduces the baseline bit for
  bit, and each (knob, value)'s parity verdict equals the JAX tuner's on
  the same cutout (the JAX `runtime.search` needs
  `jax.core.trace_state_clean`, set through monkeypatch for the test);
- `save_entry` into a temporary copy of the committed cache: the port's key
  added, the JAX entry unchanged as text, no ``.tmp`` left behind, the
  runtime's next lookup reading the entry;
- the CLI's `main()` with ``--device cpu --out <tmp>`` at a tiny n.
"""
import dataclasses
import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ProMIPS as JaxProMIPS
from repro.core.index import build_index as jax_build_index
from repro.tune import cutout as jax_cutout
from repro.tune import search as jax_search
from repro_torch.convert import index_from_numpy
from repro_torch.core.index import IndexArrays
from repro_torch.core.promips import ProMIPS
from repro_torch.core.runtime import RuntimeConfig, search
from repro_torch.tune import cache, cutout, space
from repro_torch.tune import search as tsearch
from repro_torch.tune.__main__ import main as tune_main

# one intra-op thread: the reduced shapes gain nothing from more, and
# beside the other test processes idle threads spin (a reduced train
# run took 25x the CPU time with the default thread count)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(ROOT, "results", "tune", "tuning.json")
K = 10
BUILD = dict(m=8, c=0.9, p=0.6, k_p=5, k_sp=8, norm_strata=4, seed=0)
# the JAX smoke descent (tests/test_tune.py::test_tuned_point_smoke_descent)
SMOKE_BUILD = dict(m=8, c=0.9, p=0.6, k_p=4, k_sp=4, norm_strata=2, seed=0)
SMOKE_SEARCH = dict(k=5, norm_adaptive=True, cs_prune=True)
PARITY = {"accepted": True, "rejected_slower": True, "rejected_parity": False}


@pytest.fixture
def jax_clean(monkeypatch):
    """`jax.core.trace_state_clean`, which the JAX `runtime.search` asks for
    and this jax lacks, set for one test."""
    monkeypatch.setattr(jax.core, "trace_state_clean", lambda: True,
                        raising=False)


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    """A temporary copy of the committed cache, with ``REPRO_TUNE_CACHE``
    pointing at it and the memo cleared on entry and exit."""
    path = str(tmp_path / "tuning.json")
    shutil.copyfile(COMMITTED, path)
    monkeypatch.setenv(cache.ENV_VAR, path)
    cache.clear_memo()
    yield path
    cache.clear_memo()


@pytest.mark.parametrize("n,d,n_q,seed", [(1500, 24, 8, 0), (777, 33, 5, 3),
                                          (4096, 128, 64, 7),
                                          (100_000, 128, 64, 0)])
def test_make_cutout_bit_for_bit(n, d, n_q, seed):
    x, q = cutout.make_cutout(n, d, n_q, seed=seed)
    jx, jq = jax_cutout.make_cutout(n, d, n_q, seed=seed)
    assert x.dtype == jx.dtype == np.float32 and q.dtype == jq.dtype
    assert np.array_equal(x.view(np.int32), jx.view(np.int32))
    assert np.array_equal(q.view(np.int32), jq.view(np.int32))


@pytest.fixture(scope="module")
def index():
    x, q = cutout.make_cutout(4000, 48, 16, rank=12)
    ref = jax_build_index(x, **BUILD)
    host = {f: np.asarray(getattr(ref.arrays, f)) for f in IndexArrays._fields}
    arrays, meta = index_from_numpy(host, dataclasses.asdict(ref.meta),
                                    device="cpu")
    return dict(x=x, q=q, arrays=arrays, meta=meta, jmeta=ref.meta,
                jarrays=jax.tree.map(jnp.asarray, ref.arrays))


@pytest.mark.parametrize("prefilter,eps", [(False, 1.0), (True, 1.0),
                                           (True, 0.3)])
def test_round1_union_tile_and_cap_candidates_match_jax(index, prefilter,
                                                        eps):
    kw = dict(k=K, prefilter=prefilter, prefilter_eps=eps)
    u = cutout.round1_union(index["arrays"], index["meta"], index["q"], **kw)
    ju = jax_cutout.round1_union(index["jarrays"], index["jmeta"], index["q"],
                                 **kw)
    assert u == ju and 0 < u < index["meta"].n_blocks
    _, mask = cutout.round1_masks(index["arrays"], index["meta"], index["q"],
                                  **kw)
    _, jmask = jax_cutout.round1_masks(index["jarrays"], index["jmeta"],
                                       index["q"], **kw)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    for dense_frac, tile_cap in ((0.9, None), (0.05, None), (0.9, u // 2)):
        recs = cutout.stage_records(index["arrays"], index["meta"],
                                    index["q"], dense_frac=dense_frac,
                                    tile_cap=tile_cap, reps=1, **kw)
        jrecs = jax_cutout.stage_records(index["jarrays"], index["jmeta"],
                                         index["q"], dense_frac=dense_frac,
                                         tile_cap=tile_cap, reps=1, **kw)
        assert recs["_tile"] == jrecs["_tile"]
        stages = {"select_frontend", "fused_verify_tile", "topk_rescore"}
        if prefilter:
            stages.add("prefilter_round1")
        assert set(recs) - {"_tile"} == stages == set(jrecs) - {"_tile"}
        for rec in (recs[s] for s in stages):
            assert rec["static_upper_bound"] is False
            assert rec["us"] > 0 and rec["roofline_s"] > 0
            assert rec["roofline_frac"] == rec["roofline_s"] / (rec["us"] * 1e-6)
    pm = types.SimpleNamespace(arrays=index["arrays"], meta=index["meta"])
    jpm = types.SimpleNamespace(arrays=index["jarrays"], meta=index["jmeta"])
    assert (tsearch._tile_cap_candidates(pm, index["q"], kw)
            == jax_search._tile_cap_candidates(jpm, index["q"], kw))


def _verdicts(trace):
    return {(r["knob"], r["value"]): PARITY[r["status"]]
            for r in trace["candidates"] if r.get("status") in PARITY}


def test_tune_point_smoke_matches_jax_verdicts(jax_clean):
    x, q = cutout.make_cutout(1500, 24, 8, seed=0)
    kw = dict(build_opts=SMOKE_BUILD, search_opts=SMOKE_SEARCH, budget_s=30.0,
              reps=2, include_build=False, stages=False, roofline=False,
              write=False)
    entry = tsearch.tune_point(x, q, device="cpu", **kw)
    jentry = jax_search.tune_point(x, q, **kw)
    summary = entry["trace"]["summary"]
    assert summary["elapsed_s"] < 120.0
    assert set(entry["runtime"]) == set(space.HAND_PICKED["runtime"])
    for rec in entry["trace"]["candidates"]:
        assert "status" in rec and not rec["status"].startswith("error")
    assert summary["speedup_tuned_vs_default"] > 0.0
    # the winner reproduces the hand-picked baseline bit for bit
    pm = ProMIPS.build(x, device="cpu", **SMOKE_BUILD)
    base = dict(space.HAND_PICKED["runtime"], prefilter_eps=1.0)
    assert tsearch._result_parity(
        tsearch._search_fn(pm, q, SMOKE_SEARCH, base)(),
        tsearch._search_fn(pm, q, SMOKE_SEARCH, entry["runtime"])())
    # each (knob, value) both tuners measured got the same parity verdict
    mine, theirs = _verdicts(entry["trace"]), _verdicts(jentry["trace"])
    both = set(mine) & set(theirs)
    assert ("verification", "batched") in both
    assert {key: mine[key] for key in both} == {key: theirs[key]
                                                for key in both}


@pytest.mark.parametrize("search_opts", [
    SMOKE_SEARCH, dict(SMOKE_SEARCH, prefilter=True, prefilter_eps=0.1)])
def test_parity_verdict_of_every_candidate_matches_jax(jax_clean,
                                                       search_opts):
    """The gate's verdict for each candidate of every runtime knob against
    the hand-picked baseline, in each package, independent of timing."""
    x, q = cutout.make_cutout(1500, 24, 8, seed=0)
    pm = ProMIPS.build(x, device="cpu", **SMOKE_BUILD)
    jpm = JaxProMIPS.build(x, **SMOKE_BUILD)
    base = dict(space.HAND_PICKED["runtime"],
                prefilter_eps=float(search_opts.get("prefilter_eps", 1.0)))
    ref = tsearch._search_fn(pm, q, search_opts, base)()
    jref = jax_search._search_fn(jpm, q, search_opts, base)()
    cands = {"verification": ["batched"],
             "dense_frac": [0.5, 0.7, 0.8, 1.0],
             "tile_cap": tsearch._tile_cap_candidates(pm, q, search_opts)}
    assert cands["tile_cap"] == jax_search._tile_cap_candidates(
        jpm, q, search_opts)
    if search_opts.get("prefilter"):
        cands["prefilter_eps"] = [0.05, 0.08, 0.15, 0.2]
    for name, values in cands.items():
        for v in values:
            knobs = {**base, name: v}
            got = tsearch._result_parity(
                ref, tsearch._search_fn(pm, q, search_opts, knobs)())
            want = jax_search._result_parity(
                jref, jax_search._search_fn(jpm, q, search_opts, knobs)())
            assert got == want, (name, v)


def test_save_entry_adds_its_key_and_keeps_the_jax_entry(tmp_cache):
    with open(tmp_cache) as f:
        before_text = f.read()
    before = json.loads(before_text)
    (jax_key,) = before["entries"]
    n, d = 100_000, 128
    runtime = {"verification": "fused", "dense_frac": 0.8, "tile_cap": 96,
               "prefilter_eps": 0.1}
    assert cache.lookup(n, d, device="cpu") is None        # memoized miss
    key = cache.save_entry(n, d, device="cpu", runtime=runtime,
                           build={"page_bytes": 4096, "max_probe_groups": None},
                           trace={"summary": {"n": n}}, path=tmp_cache)
    assert key == space.shape_key(n, d, "cpu") != jax_key
    assert key.endswith(f":cpu:torch{torch.__version__}")
    assert not [p for p in os.listdir(os.path.dirname(tmp_cache))
                if p.endswith(".tmp")]
    with open(tmp_cache) as f:
        after_text = f.read()
    after = json.loads(after_text)
    assert after["entries"][jax_key] == before["entries"][jax_key]
    entry = after["entries"][key]
    assert entry["key"] == {"n_bucket": 131072, "d": 128, "platform": "cpu",
                            "torch_version": torch.__version__}
    assert entry["provenance"]["commit"] and entry["provenance"]["ts"]
    # the JAX entry is unchanged as text: the file without the port's key
    # is the committed file, byte for byte
    del after["entries"][key]
    assert json.dumps(after, indent=1, sort_keys=True) + "\n" == before_text
    # the memo was dropped: the next lookup reads the entry at once
    assert cache.lookup(n, d, device="cpu")["runtime"] == runtime
    assert cache.resolved("runtime", 90_000, d, device="cpu")["tile_cap"] == 96
    # a second write replaces its own key only
    cache.save_entry(n, d, device="cpu", runtime=dict(runtime, tile_cap=64),
                     path=tmp_cache)
    again = json.load(open(tmp_cache))
    assert set(again["entries"]) == {jax_key, key}
    assert again["entries"][jax_key] == before["entries"][jax_key]
    assert cache.resolved("runtime", n, d, device="cpu")["tile_cap"] == 64


def test_save_entry_refuses_a_file_it_cannot_read(tmp_path):
    path = str(tmp_path / "tuning.json")
    with open(path, "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError):
        cache.save_entry(1000, 8, device="cpu", runtime={}, path=path)
    assert open(path).read() == "{not json"
    assert not os.path.exists(path + ".tmp")


def test_runtime_reads_a_written_entry(index, tmp_cache):
    """A search with the knobs left None after `save_entry` equals, bit for
    bit, one with the written knobs passed explicitly."""
    meta = index["meta"]
    q = torch.from_numpy(index["q"])
    tuned = {"verification": "fused", "dense_frac": 0.5, "tile_cap": 64,
             "prefilter_eps": 0.3}
    assert tuned["tile_cap"] < meta.n_blocks
    cache.save_entry(meta.n, meta.d, device="cpu", runtime=tuned,
                     path=tmp_cache)
    cfg = dict(k=K, prefilter=True, prefilter_eps=0.3)
    got = search(index["arrays"], meta, q, RuntimeConfig(**cfg), device="cpu")
    want = search(index["arrays"], meta, q,
                  RuntimeConfig(**cfg, dense_frac=0.5, tile_cap=64),
                  device="cpu")
    hand = search(index["arrays"], meta, q,
                  RuntimeConfig(**cfg, dense_frac=0.9,
                                tile_cap=meta.n_blocks), device="cpu")
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)
    assert not torch.equal(got[2].pages, hand[2].pages)    # the cap truncates


def test_cli_writes_its_key(tmp_path, capsys):
    out = str(tmp_path / "tuning.json")
    shutil.copyfile(COMMITTED, out)
    tune_main(["--device", "cpu", "--out", out, "--n", "1500", "--d", "24",
               "--n-q", "8", "--m", "8", "--k-p", "4", "--k-sp", "4",
               "--norm-strata", "2", "--prefilter", "--budget-s", "10",
               "--reps", "1"])
    printed = capsys.readouterr().out
    report = json.loads(printed[printed.index("{\n"):])
    key = space.shape_key(1500, 24, "cpu")
    assert report["key"] == key
    written = json.load(open(out))["entries"]
    assert key in written and len(written) == 2
    assert written[key]["runtime"] == report["runtime"]
    assert written[key]["build"]["page_bytes"] == 4096
    statuses = [r["status"] for r in written[key]["trace"]["candidates"]]
    assert statuses and not any(s.startswith("error") for s in statuses)
    assert set(written[key]["trace"]["stages_best"]) >= {
        "select_frontend", "prefilter_round1", "topk_rescore"}
