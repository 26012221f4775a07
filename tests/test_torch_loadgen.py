"""The port's open-loop Zipfian load generator (`repro_torch.serve.loadgen`)
against the JAX package's `repro.serve.loadgen`, on the CPU.

The schedule is drawn with numpy from the seed, so `zipf_probs` and
`generate` must equal the JAX ones exactly, field for field, over several
configs; `LoadgenConfig` must refuse what the JAX one refuses. `run_load`
replays in wall-clock time, so its numbers are held by the invariants of
`tests/test_loadgen.py` on a reduced-config CPU engine: every request
completes and is summarized, shed and expired requests are counted and add
up, and a saturating ramp trips the degradation ladder.
"""
import dataclasses

import numpy as np
import pytest

from repro.serve import loadgen as jax_loadgen
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serve import (DecodeEngine, DegradationPolicy, LoadgenConfig,
                               generate, run_load)
from repro_torch.serve.loadgen import Arrival, zipf_probs

CONFIGS = [
    dict(),
    dict(rate_qps=100.0, n_requests=40, zipf_s=1.2, pool_size=6,
         prompt_lens=(3, 9), max_new_tokens_choices=(2, 5),
         deadline_mix=((None, 1.0), (0.25, 1.0)), seed=3),
    dict(rate_qps=7.5, n_requests=200, zipf_s=0.0, pool_size=17,
         prompt_lens=(1, 1), ramp=10.0, seed=11),
    dict(rate_qps=1e4, n_requests=33, zipf_s=2.5, pool_size=1,
         deadline_mix=((0.0, 1.0), (None, 3.0), (1.5, 0.5)), ramp=0.25,
         seed=5),
]
BAD = [dict(rate_qps=0.0), dict(n_requests=0), dict(pool_size=0),
       dict(zipf_s=-0.1), dict(ramp=0.0), dict(prompt_lens=(5, 3)),
       dict(prompt_lens=(0, 3)), dict(max_new_tokens_choices=()),
       dict(deadline_mix=())]


@pytest.fixture(scope="module")
def small_model():
    cfg = get_config("tinyllama-1.1b").reduced()
    return cfg, T.init_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("pool,s", [(1, 1.1), (8, 0.0), (16, 1.1), (50, 2.3)])
def test_zipf_probs_equal_jax(pool, s):
    got = zipf_probs(pool, s)
    np.testing.assert_array_equal(got, jax_loadgen.zipf_probs(pool, s))
    assert got.dtype == np.float64 and np.isclose(got.sum(), 1.0)


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_generate_equals_jax_field_for_field(kw):
    vocab = 512
    got = generate(LoadgenConfig(**kw), vocab)
    want = jax_loadgen.generate(jax_loadgen.LoadgenConfig(**kw), vocab)
    assert len(got) == len(want) == LoadgenConfig(**kw).n_requests
    fields = [f.name for f in dataclasses.fields(Arrival)]
    assert fields == [f.name for f in dataclasses.fields(jax_loadgen.Arrival)]
    for a, b in zip(got, want):
        for name in fields:
            x, y = getattr(a, name), getattr(b, name)
            if name == "prompt":
                assert x.dtype == y.dtype == np.int32
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y and type(x) is type(y), name
    assert [a.t for a in got] == sorted(a.t for a in got)


@pytest.mark.parametrize("kw", BAD, ids=[next(iter(k)) for k in BAD])
def test_config_validation_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError):
        jax_loadgen.LoadgenConfig(**kw)
    with pytest.raises(ValueError):
        LoadgenConfig(**kw)


def test_run_load_completes_and_summarizes(small_model):
    cfg, params = small_model
    eng = DecodeEngine(params, cfg, batch_slots=2, max_len=64, device="cpu")
    lg = LoadgenConfig(rate_qps=200.0, n_requests=8, pool_size=3,
                       prompt_lens=(4, 6), max_new_tokens_choices=(3,),
                       seed=1)
    arrivals = generate(lg, cfg.vocab)
    s = run_load(eng, arrivals, max_wall_s=60.0)
    assert s["requests"] == 8 and s["completed"] == 8
    assert s["shed_frac"] == 0.0 and s["expired_frac"] == 0.0
    assert s["decoded_tokens"] == 8 * 3
    assert s["queries_per_s"] > 0 and s["wall_s"] > 0
    assert s["latency_p99_s"] >= s["latency_p50_s"] > 0
    assert s["queue_wait_p99_s"] >= s["queue_wait_p50_s"] >= 0
    assert s["final_state"] == "ok" and "cache" not in s
    occ = s["tier_occupancy"]
    assert occ and abs(sum(occ.values()) - 1.0) < 1e-9
    assert all(a.request is not None and not a.shed for a in arrivals)
    assert all(len(a.request.out_tokens) == 4 for a in arrivals)


def test_run_load_accounts_shed_and_expired(small_model):
    """Saturating arrivals against one slot and a queue of one shed some
    requests at submission; a 0-second deadline expires the queued rest,
    and the shares add up with the completed count."""
    cfg, params = small_model
    eng = DecodeEngine(params, cfg, batch_slots=1, max_len=64, max_queue=1,
                       device="cpu")
    lg = LoadgenConfig(rate_qps=1e4, n_requests=10, pool_size=2,
                       prompt_lens=(4, 4), max_new_tokens_choices=(2,),
                       deadline_mix=((0.0, 1.0),), seed=2)
    arrivals = generate(lg, cfg.vocab)
    s = run_load(eng, arrivals, max_wall_s=60.0)
    assert s["shed_frac"] > 0
    n_shed = sum(a.shed for a in arrivals)
    n_expired = sum(a.request.expired for a in arrivals if a.request)
    assert n_shed + n_expired + s["completed"] == 10
    assert s["shed_frac"] == n_shed / 10 == eng.shed / 10
    assert s["expired_frac"] == n_expired / 10
    assert not eng.queue and not eng.active.any()


def test_run_load_trips_degradation_ladder(small_model):
    cfg, params = small_model
    pol = DegradationPolicy(tiers=(1.0, 0.5), recall_floors=(0.95, 0.8),
                            queue_high=2, queue_low=0, patience=1,
                            recovery=1000)
    eng = DecodeEngine(params, cfg, batch_slots=1, max_len=64,
                       logits_mode="promips",
                       promips_kwargs=dict(m=8, c=0.95, p=0.95),
                       degradation=pol, device="cpu")
    lg = LoadgenConfig(rate_qps=1e4, n_requests=8, pool_size=2,
                       prompt_lens=(4, 4), max_new_tokens_choices=(4,),
                       seed=4)
    s = run_load(eng, generate(lg, cfg.vocab), max_wall_s=120.0)
    assert s["stepdowns"] >= 1 and s["max_tier"] >= 1
    assert s["tier_occupancy"].get("1", 0) > 0
    assert s["cache"] == eng.qcache.stats()
    eng.join_compaction()
