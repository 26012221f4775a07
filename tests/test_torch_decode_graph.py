"""What the engine's captured decode step relies on, on the CPU, against the
JAX package at the reduced tinyllama config (4 layers, d_model 128, vocab
512), f32, with the JAX parameters carried across by
`convert.params_from_jax`.

- `decode_step` updates the cache in place: ``len``, ``k`` and ``v`` keep
  their identity over three steps (a CUDA graph captured over them stays
  valid), while the logits, the hidden state and the cache stay within
  1e-4 absolute of the JAX `decode_step` (GEMMs sum in other orders in
  the two frameworks; the bound of `tests/test_torch_model.py`).
- A CPU engine's ``_decode`` and ``_decode_hidden`` are the plain eager
  function: bit for bit what `decode_step` gives on the same cache.
- `DecodeEngine.update` mid-traffic: the tokens equal the JAX engine's in
  both modes; the first refresh copies the embed table (the caller's
  tensor stays untouched), later ones write into that copy in place.

The graph itself (capture, replay, launch counts, a capture after
`update`) needs the card: `tests/test_torch_cuda_kernels.py`. The JAX
engine's promips search needs `jax.core.trace_state_clean` (gone in newer
jax): the `jax_search` fixture sets it through pytest's monkeypatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.serve.engine import DecodeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as T
from repro_torch.serve import DecodeEngine
from repro_torch.serve import engine as engine_lib

# one intra-op thread: the reduced shapes gain nothing from more, and
# beside the other test processes idle threads spin (a reduced train
# run took 25x the CPU time with the default thread count)
torch.set_num_threads(1)

ATOL_MODEL = 1e-4


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


def _prefilled(model, seed=0):
    cfg, jcfg, params, jparams = model
    tokens = np.random.RandomState(seed).randint(1, cfg.vocab, (3, 7)).astype(
        np.int32)
    jcache, jlogits = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                                 24)
    cache, _ = T.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)}, 24)
    tok = np.asarray(jnp.argmax(jlogits[:, :cfg.vocab], -1)).astype(
        np.int32)[:, None]
    return cache, jcache, tok


def _clone(cache):
    return {name: t.clone() for name, t in cache.items()}


def test_decode_step_keeps_the_cache_identity_and_equals_jax(model):
    cfg, jcfg, params, jparams = model
    cache, jcache, tok = _prefilled(model)
    ids = {name: id(t) for name, t in cache.items()}
    ptrs = {name: t.data_ptr() for name, t in cache.items()}
    for step in range(3):
        hidden = step == 1
        out, new = T.decode_step(params, cfg, cache, torch.from_numpy(tok),
                                 return_hidden=hidden)
        jout, jcache = JT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                                      return_hidden=hidden)
        assert new is cache
        assert {name: id(t) for name, t in new.items()} == ids
        assert {name: t.data_ptr() for name, t in new.items()} == ptrs
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                                   atol=ATOL_MODEL, err_msg=f"step {step}")
        np.testing.assert_array_equal(cache["len"].numpy(),
                                      np.asarray(jcache["len"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jcache[name]), rtol=0,
                                       atol=ATOL_MODEL, err_msg=name)
        jlg = jout if not hidden else JT._logits(jparams, jcfg, jout)
        tok = np.asarray(jnp.argmax(jlg[:, :cfg.vocab], -1)).astype(
            np.int32)[:, None]


@pytest.mark.parametrize("variant,hidden", [("_decode", False),
                                            ("_decode_hidden", True)])
def test_cpu_engine_decode_is_the_plain_function(model, variant, hidden):
    cfg, _, params, _ = model
    eng = DecodeEngine(params, cfg, batch_slots=3, max_len=24, result_cache=0,
                       max_refill=None, device="cpu")
    fn = getattr(eng, variant)
    assert not isinstance(fn, engine_lib._DecodeGraph)
    cache, _, tok = _prefilled(model, seed=1)
    want_cache = _clone(cache)
    tok = torch.from_numpy(tok)
    for _ in range(3):
        got, got_cache = fn(eng.params, cache, tok)
        want, want_cache = T.decode_step(params, cfg, want_cache, tok,
                                         return_hidden=hidden)
        assert got_cache is cache
        assert got.shape == ((3, cfg.d_model) if hidden
                             else (3, cfg.vocab_padded))
        assert torch.equal(got, want)
        for name in ("len", "k", "v"):
            assert torch.equal(cache[name], want_cache[name]), name


def _prompts(cfg, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, cfg.vocab, size=8 if i % 2 else 12).astype(np.int32)
            for i in range(n)]


@pytest.mark.parametrize("mode", ["exact", "promips"])
def test_update_mid_traffic_equals_jax(model, jax_search, mode):
    """Requests in flight across two refreshes of embedding rows (one a row
    the traffic emits): the tokens equal the JAX engine's."""
    cfg, jcfg, params, jparams = model
    kw = dict(batch_slots=3, max_len=64, result_cache=0, max_refill=None,
              logits_mode=mode)
    je = JaxEngine(jparams, jcfg, **kw)
    te = DecodeEngine(params, cfg, device="cpu", **kw)
    caller_embed = params["embed"]
    before = caller_embed.clone()
    prompts = _prompts(cfg, 7, seed=6)
    jreqs = [je.submit(p, max_new_tokens=8) for p in prompts]
    treqs = [te.submit(p, max_new_tokens=8) for p in prompts]
    rng = np.random.RandomState(7)
    for phase in range(3):
        for _ in range(3):
            je.step()
            te.step()
        if phase == 2:
            break
        emitted = sorted({t for r in treqs for t in r.out_tokens if t})
        ids = [emitted[phase], int(rng.randint(1, cfg.vocab))]
        if ids[0] == ids[1]:
            ids = ids[:1]
        rows = (rng.standard_normal((len(ids), cfg.d_model)) * 0.05).astype(
            np.float32)
        for eng in (je, te):
            eng.update(ids, rows)
        np.testing.assert_array_equal(te.params["embed"][ids].numpy(), rows)
        if phase == 0:
            owned = te.params["embed"]
            assert owned is not caller_embed
        else:   # the second refresh writes into the engine's copy in place
            assert te.params["embed"] is owned
    je.run()
    te.run()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert te.steps == je.steps and te.steps > 6
    assert torch.equal(caller_embed, before)
    if mode == "promips":
        for eng in (je, te):
            eng.join_compaction()
