"""The MoE, vision-stub and encoder-decoder models of the port (plain
PyTorch on the CPU) against the JAX package, at the configs' `.reduced()`
sizes, f32, with the JAX parameters of `init_params(PRNGKey(0), cfg)`
carried across by `convert.params_from_jax`: qwen2-moe-a2.7b (8 experts,
top-2, 1 shared), moonshot-v1-16b-a3b (8 experts, top-2), internvl2-2b (8
patches, GQA 4/2) and whisper-base (2 + 4 layers, 8 frames).

Tolerances:
- `prefill` and eight `decode_step`s: logits within 1e-5 of the largest
  |logit| (relative; GEMMs sum in other orders), the argmax tokens equal,
  every cache leaf within 1e-5 relative;
- `loss_fn`: loss, aux and every gradient leaf within `train.parity`'s
  GRAD_TOL (1e-5) of the leaf's largest, under remat ``dots`` for the MoE
  configs and ``full`` for the others (the vision label offset and the
  encoder-decoder loss among them);
- three `make_train_step` steps against the jitted JAX step (internvl2-2b
  free, the others each from the JAX state): loss, grad norm and lr within GRAD_TOL, params / mu / nu
  within GRAD_TOL (params beyond one step's `parity.adam_allowance`);
- `DecodeEngine` against the JAX `DecodeEngine` in exact and ProMIPS
  modes, `launch.serve.main` against the JAX `launch.serve.main`, the
  serve example against the JAX example, and the recsys example's
  `churn_loop` against the JAX one: tokens and ids equal.

The JAX engine's ProMIPS search goes through `runtime.search`, which needs
`jax.core.trace_state_clean` (gone in newer jax): the `jax_search` fixture
sets it through pytest's monkeypatch, which undoes it at teardown.
"""
import dataclasses
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.models import transformer as JT
from repro.serve import engine as jax_engine
from repro.train import loop as jax_loop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.serve import DecodeEngine
from repro_torch.train import loop, parity

# one intra-op thread: the reduced shapes gain nothing from more, and
# beside the other test processes idle threads spin (a reduced train
# run took 25x the CPU time with the default thread count)
torch.set_num_threads(1)

FAMILIES = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "internvl2-2b",
            "whisper-base")
REMAT = {"qwen2-moe-a2.7b": "dots", "moonshot-v1-16b-a3b": "dots",
         "internvl2-2b": "full", "whisper-base": "full"}
# train steps that each start from the JAX state (the others run free)
RESYNC = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "whisper-base")
RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


@pytest.fixture
def jax_search(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", lambda: True,
                        raising=False)


@pytest.fixture(scope="module")
def carried():
    out = {}
    for name in FAMILIES:
        cfg, jcfg = get_config(name).reduced(), jax_get_config(name).reduced()
        jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
        out[name] = (cfg, jcfg, jparams, params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    return out


def _rel(got, want):
    return parity.rel(got, want)


def _batch(cfg, b, s, seed, labels=False):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(1, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if labels:
        batch["labels"] = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
        batch["labels"][0, :3] = -1
    return batch


def _t(batch):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in batch.items()}


def test_the_four_configs_equal_the_jax_ones():
    for name in FAMILIES:
        assert get_config(name) == get_config(
            name.replace("-", "_").replace(".", "_"))
        for full in (False, True):
            cfg, jcfg = get_config(name), jax_get_config(name)
            if not full:
                cfg, jcfg = cfg.reduced(), jcfg.reduced()
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_eight_decode_steps_match_jax(carried, name):
    cfg, jcfg, jparams, params = carried[name]
    batch = _batch(cfg, 2, 12, seed=1)
    jcache, jlg = JT.prefill(jparams, jcfg, jax.tree.map(jnp.asarray, batch), 48)
    cache, lg = T.prefill(params, cfg, _t(batch), 48)
    assert sorted(cache) == sorted(jcache)
    assert _rel(lg, jlg) <= RTOL
    for key in cache:
        assert cache[key].shape == jcache[key].shape, key
        assert _rel(cache[key], jcache[key]) <= RTOL, key
    tok = np.asarray(jlg).argmax(-1)[:, None].astype(np.int32)
    assert (lg.numpy().argmax(-1) == tok[:, 0]).all()
    for step in range(8):
        jlg, jcache = JT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
        lg, cache = T.decode_step(params, cfg, cache, torch.from_numpy(tok))
        assert _rel(lg, jlg) <= RTOL, step
        assert (lg.numpy().argmax(-1) == np.asarray(jlg).argmax(-1)).all(), step
        tok = np.asarray(jlg).argmax(-1)[:, None].astype(np.int32)
    for key in cache:
        assert _rel(cache[key], jcache[key]) <= RTOL, key
    hid, _ = T.decode_step(params, cfg, cache, torch.from_numpy(tok),
                           return_hidden=True)
    jhid, _ = JT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                             return_hidden=True)
    assert _rel(hid, jhid) <= RTOL


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_fn_and_grads_match_jax(carried, name):
    cfg, jcfg, jparams, params = carried[name]
    remat = REMAT[name]
    batch = _batch(cfg, 2, 16, seed=2, labels=True)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b, remat=remat), has_aux=True))(
            jparams, batch)
    leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(params)]
    loss, m = T.loss_fn(tree_lib.unflatten(params, leaves), cfg, _t(batch),
                        remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    assert _rel(loss.detach(), jloss) <= parity.GRAD_TOL
    assert _rel(m["loss"].detach(), jm["loss"]) <= parity.GRAD_TOL
    assert _rel(m["aux"].detach(), jm["aux"]) <= parity.GRAD_TOL
    if cfg.moe is not None:
        assert float(m["aux"].detach()) > 0
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for leaf, g, jg in zip(parity.leaf_names(params), grads, jleaves):
        assert _rel(g, jg) <= parity.GRAD_TOL, leaf


@pytest.mark.parametrize("name", FAMILIES)
def test_three_train_steps_match_jax(name):
    """`make_train_step` on batches that carry the frontend's patches or
    frames (`lm_batch`'s layout), microbatches 2, lr 1e-3. internvl2-2b runs
    free (its moments stay within 5e-6 of their leaf's largest over the
    three steps). For the RESYNC configs each step starts from the JAX state
    carried across: run free, the parameter differences that Adam's
    normalization allows (up to 2 * lr an element a step, for elements whose
    gradient is small) move the next step's gradients, and the moments part
    by up to 6.0e-5 (qwen2-moe, step 2), 3.0e-5 (moonshot, step 2) and
    1.9e-5 (whisper, step 1) of their leaf's largest, though every step's
    own gradients agree within 1e-5."""
    kw = dict(lr=1e-3, warmup=2, total_steps=20, microbatches=2,
              remat=REMAT[name])
    jcfg, jt = jax_get_config(name).reduced(), jax_loop.TrainCfg(**kw)
    jstate = jax_loop.init_state(JT.init_params(jax.random.PRNGKey(0), jcfg), jt)
    cfg = get_config(name).reduced()
    jstep = jax.jit(jax_loop.make_train_step(jcfg, jt))
    step = loop.make_train_step(cfg, loop.TrainCfg(**kw))
    state, allowance = train_state_from_jax(jstate, cfg, "cpu"), None
    for i in range(3):
        batch = _batch(cfg, 4, 16, seed=10 + i, labels=True)
        if name in RESYNC:
            state, allowance = train_state_from_jax(jstate, cfg, "cpu"), None
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        for key in ("loss", "grad_norm", "lr"):
            assert _rel(m[key], jm[key]) <= parity.GRAD_TOL, key
        allowance = parity.adam_allowance(allowance, jstate, float(jm["lr"]))
        r = parity.compare_states(state, jstate, allowance=allowance)
        for part in ("params", "mu", "nu"):
            assert r[part] <= parity.GRAD_TOL, (i, part, r)
        assert int(state.step) == int(jstate.step) == i + 1


# ---------------------------------------------------------------- serving


def _prompts(cfg, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, cfg.vocab, size=8 if i % 2 else 12).astype(np.int32)
            for i in range(n)]


@pytest.mark.parametrize("mode", ["exact", "promips"])
@pytest.mark.parametrize("name", FAMILIES)
def test_engine_matches_jax(carried, jax_search, name, mode):
    """Six requests of two prompt lengths through three slots: every
    request's tokens and the engines' counters equal; the cache holds
    every leaf of the model's (the encoder K/V and length too)."""
    cfg, jcfg, jparams, params = carried[name]
    kw = dict(batch_slots=3, max_len=48, result_cache=0, max_refill=None,
              logits_mode=mode)
    je = jax_engine.DecodeEngine(jparams, jcfg, **kw)
    te = DecodeEngine(params, cfg, device="cpu", **kw)
    prompts = _prompts(cfg, 6, seed=3)
    out = []
    for eng in (je, te):
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        eng.run()
        out.append([r.out_tokens for r in reqs])
    assert out[1] == out[0]
    for key in ("steps", "pages", "searched_rows", "prefill_calls"):
        assert getattr(te, key) == getattr(je, key), key
    assert sorted(te.cache) == sorted(je.cache)
    for key in te.cache:
        assert _rel(te.cache[key], je.cache[key]) <= RTOL, key
    assert te._batch_axes == {k: (1 if te.cache[k].dim() > 1 else 0)
                              for k in te.cache}


def _jax_params_for(monkeypatch):
    """Make the port's `init_params` return the JAX parameters of the same
    config (`init_params(PRNGKey(0), cfg)`), carried across."""
    def init_params(cfg, *, seed=0, device="cuda", **_):
        jcfg = jax_get_config(cfg.name)
        if dataclasses.asdict(jcfg) != dataclasses.asdict(cfg):
            jcfg = jcfg.reduced()
        jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
        return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device)
    monkeypatch.setattr(T, "init_params", init_params)


@pytest.mark.parametrize("name,mode", [("qwen2-moe-a2.7b", "promips"),
                                       ("whisper-base", "exact"),
                                       ("internvl2-2b", "promips")])
def test_launch_serve_main_matches_jax(jax_search, monkeypatch, capsys, name,
                                       mode):
    argv = ["--arch", name, "--reduced", "--requests", "5", "--slots", "2",
            "--prompt-len", "10", "--max-new", "4", "--max-len", "64",
            "--logits-mode", mode]
    jreqs = jax_serve.main(argv)
    _jax_params_for(monkeypatch)
    reqs = launch_serve.main(argv + ["--device", "cpu"])
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    out = capsys.readouterr().out
    assert out.count("served 5 requests") == 2


def test_serve_example_matches_the_jax_example(jax_search, monkeypatch, capsys):
    """The JAX example's engines are recorded through a subclass of its
    `DecodeEngine`; the port's example returns its tokens."""
    runs = []

    class Recording(jax_engine.DecodeEngine):
        def submit(self, *a, **kw):
            req = super().submit(*a, **kw)
            runs[-1].append(req)
            return req

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append([])

    with monkeypatch.context() as m:
        m.setattr(jax_engine, "DecodeEngine", Recording)
        runpy.run_path(os.path.join(EXAMPLES, "serve_lm_promips.py"),
                       run_name="__main__")
    want = {mode: [r.out_tokens for r in reqs]
            for mode, reqs in zip(("exact", "promips"), runs)}
    _jax_params_for(monkeypatch)
    example = runpy.run_path(os.path.join(EXAMPLES, "serve_lm_promips_torch.py"),
                             run_name="not_main")
    got = example["main"](["--device", "cpu"])
    assert got == want
    lines = capsys.readouterr().out.splitlines()
    agree = [ln for ln in lines if ln.startswith("greedy agreement")]
    assert len(agree) == 2 and agree[0] == agree[1]


def test_recsys_churn_loop_matches_the_jax_one(jax_search, monkeypatch, capsys):
    """`churn_loop` on 8,000 items (4,000 live, then four rounds of 1,000
    deletes, 2,000 inserts and 200 refreshes): each round's ids equal to
    the JAX example's, recall 1 in every round."""
    from repro_torch.data.synthetic import mf_factors
    items = mf_factors(8000, 32, 16, decay=0.15, seed=0, norm_tail=0.3)
    users = mf_factors(8, 32, 16, decay=0.15, seed=1)
    searched = []
    build = jax_api.build

    def recording_build(*a, **kw):
        s = build(*a, **kw)
        search = s.search

        def search_and_keep(*a2, **kw2):
            res = search(*a2, **kw2)
            searched.append(np.asarray(res.ids))
            return res
        s.search = search_and_keep
        return s

    with monkeypatch.context() as m:
        m.setattr(jax_api, "build", recording_build)
        jax_mod = runpy.run_path(os.path.join(EXAMPLES, "recsys_retrieval.py"),
                                 run_name="not_main")
        jax_mod["churn_loop"](items, users)
    port = runpy.run_path(os.path.join(EXAMPLES, "recsys_retrieval_torch.py"),
                          run_name="not_main")
    rounds = port["churn_loop"](items, users, device="cpu")
    assert len(rounds) == len(searched) == 4
    for (ids, recall), jids in zip(rounds, searched):
        np.testing.assert_array_equal(ids, jids)
        assert recall == 1.0
    out = capsys.readouterr().out
    assert out.count("post-churn live=") == 2
