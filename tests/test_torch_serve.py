"""The port's `serve.DecodeEngine` (plain versions, on the CPU) against the
JAX package's `repro.serve.engine.DecodeEngine` at the reduced tinyllama
config (4 layers, d_model 128, vocab 512), f32, the JAX parameters of
`init_params(PRNGKey(0), cfg)` carried across by `convert.params_from_jax`.

Both engines get the same traffic (prompts of two lengths, more requests
than slots) and the same knobs (batch_slots, result_cache and max_refill
given explicitly: the JAX engine would otherwise consult its tuning cache),
in exact and ProMIPS modes, with and without the hot-query cache, under a
degradation policy driven by queue depth, and across `delete` / `update` of
vocab rows. Held equal: every request's out_tokens, and the engines'
steps, pages, searched_rows and prefill_calls (and the ladder's moves).

The JAX engine's ProMIPS search goes through `runtime.search`, which needs
`jax.core.trace_state_clean` (gone in newer jax): the `jax_search` fixture
sets it through pytest's monkeypatch, which undoes it at teardown.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import DegradationPolicy as JaxPolicy
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.obs import metrics
from repro_torch.serve import DecodeEngine, DegradationPolicy

COUNTERS = ("steps", "pages", "searched_rows", "prefill_calls")


@pytest.fixture
def jax_search(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", lambda: True,
                        raising=False)


@pytest.fixture(scope="module")
def model():
    cfg = get_config("tinyllama-1.1b").reduced()
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return cfg, jcfg, params, jparams


def _prompts(cfg, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, cfg.vocab, size=8 if i % 2 else 12).astype(np.int32)
            for i in range(n)]


def _engines(model, **kw):
    cfg, jcfg, params, jparams = model
    kw = dict(dict(batch_slots=3, max_len=64, result_cache=0, max_refill=None),
              **kw)
    policy = kw.pop("policy", None)
    je = JaxEngine(jparams, jcfg, degradation=JaxPolicy(**policy) if policy
                   else None, **kw)
    te = DecodeEngine(params, cfg, device="cpu", degradation=DegradationPolicy(
        **policy) if policy else None, **kw)
    return je, te


def _serve(engines, prompts, max_new=6):
    out = []
    for eng in engines:
        reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.run()
        out.append(reqs)
    return out


def _assert_same(je, te, jreqs, treqs):
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    for name in COUNTERS:
        assert getattr(te, name) == getattr(je, name), name


@pytest.mark.parametrize("mode", ["exact", "promips"])
def test_engine_matches_jax(model, jax_search, mode):
    je, te = _engines(model, logits_mode=mode)
    prompts = _prompts(model[0], 8, seed=1)
    jreqs, treqs = _serve((je, te), prompts)
    _assert_same(je, te, jreqs, treqs)
    assert te.prefill_calls > 2 and te.steps > 6
    if mode == "promips":
        assert te.searched_rows > 0


def test_engine_with_result_cache_matches_jax(model, jax_search):
    je, te = _engines(model, logits_mode="promips", result_cache=64)
    prompts = _prompts(model[0], 4, seed=2) * 2      # repeated prompts
    jreqs, treqs = _serve((je, te), prompts)
    _assert_same(je, te, jreqs, treqs)
    assert te.qcache.stats() == je.qcache.stats()
    assert te.qcache.hits > 0


def test_engine_under_a_degradation_policy_matches_jax(model, jax_search):
    """The ladder steps down on queue depth alone (the latency signal is
    wall-clock, so it is switched off with a huge factor) and back up as
    the queue drains; the tiers' truncating budgets then drive the same
    searches."""
    policy = dict(tiers=(1.0, 0.5, 0.25), recall_floors=(0.95, 0.85, 0.6),
                  queue_high=4, queue_low=1, latency_factor=1e9, patience=2,
                  recovery=3)
    je, te = _engines(model, logits_mode="promips", batch_slots=2,
                      policy=policy, obs=True)
    metrics.reset()
    prompts = _prompts(model[0], 12, seed=3)
    jtiers, ttiers = [], []
    jreqs = [je.submit(p, max_new_tokens=5) for p in prompts]
    treqs = [te.submit(p, max_new_tokens=5) for p in prompts]
    while je.queue or je.active.any():
        je.step()
        jtiers.append(je.tier)
    while te.queue or te.active.any():
        te.step()
        ttiers.append(te.tier)
    assert ttiers == jtiers and max(ttiers) == 2
    assert (te.stepdowns, te.stepups) == (je.stepdowns, je.stepups)
    _assert_same(je, te, jreqs, treqs)
    for key in ("state", "tier", "tier_budget", "tier_recall_floor"):
        assert te.health()[key] == je.health()[key], key
    snap = te.metrics_snapshot()
    assert snap["serve.decode_steps"] == te.steps
    assert snap["serve.tier_stepdowns"] == te.stepdowns


def test_engine_delete_and_update_match_jax(model, jax_search):
    cfg = model[0]
    je, te = _engines(model, logits_mode="promips", result_cache=64)
    prompts = _prompts(cfg, 6, seed=4)
    jreqs, treqs = _serve((je, te), prompts)
    _assert_same(je, te, jreqs, treqs)
    emitted = sorted({t for r in treqs for t in r.out_tokens[1:] if t})
    retired = emitted[:3]
    rng = np.random.RandomState(5)
    row = (rng.standard_normal((1, cfg.d_model)) * 0.05).astype(np.float32)
    for eng in (je, te):
        eng.delete(retired)
        eng.update([emitted[-1]], row)
    jreqs, treqs = _serve((je, te), prompts)
    for eng in (je, te):
        eng.join_compaction()
    _assert_same(je, te, jreqs, treqs)
    assert not {t for r in treqs for t in r.out_tokens} & set(retired)
    np.testing.assert_array_equal(te.params["embed"][emitted[-1]].numpy(),
                                  row[0])
    assert te.health()["compaction"] == je.health()["compaction"]
