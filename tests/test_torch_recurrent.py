"""The recurrent models of the port (plain PyTorch on the CPU) against the
JAX package, f32, with the JAX parameters of `init_params(PRNGKey(0), cfg)`
carried across by `convert.params_from_jax`: xlstm-1.3b (`.reduced()`, 8
layers in 1 group, and 16 layers in 2) and zamba2-1.2b (`.reduced()`, 4
layers in 2 groups of 2 with no tail, and 5 layers, whose tail of 1 is the
branch the full config's 38 = 6 x 6 + 2 takes).

Tolerances:
- each block function (`mamba_chunked` with S not a multiple of the chunk,
  `mamba_step`, `_causal_conv` with a state, `mlstm_chunked`, `mlstm_step`,
  `slstm_scan`, `slstm_step`): every output within 1e-5 of its largest
  |value| (relative; GEMMs and einsums sum in other orders);
- `prefill` and eight `decode_step`s: logits within 1e-5 of the largest
  |logit|, the argmax tokens equal, every cache leaf (the sLSTM tuple's
  four too) within 1e-5 relative, with each -inf stabiliser at the same
  places. The xLSTM gets XLSTM_RTOL = 5e-5 instead: at these random
  weights it amplifies rounding layer by layer, so that the JAX model
  itself, with its embedding changed by one part in 2^24, moves its logits
  and states by up to 1.2e-5 at 8 layers and 1.7e-5 at 16
  (`test_xlstm_amplifies_rounding_past_1e5`). Each block alone holds 1e-5,
  and the port's logits stay within 1.7e-5 of JAX's: JAX's own spread;
- `DecodeEngine` against the JAX `DecodeEngine` in exact and ProMIPS
  modes, and `launch.serve.main` against the JAX one: tokens and counters
  equal, the engines' batch axes equal (the sLSTM tuple's included).

The JAX engine's ProMIPS search goes through `runtime.search`, which needs
`jax.core.trace_state_clean` (gone in newer jax): the `jax_search` fixture
sets it through pytest's monkeypatch, which undoes it at teardown.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.models import ssm as jax_ssm
from repro.models import transformer as JT
from repro.models import xlstm as jax_xlstm
from repro.serve import engine as jax_engine
from repro_torch.configs import all_configs, get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import ssm, xlstm
from repro_torch.models import transformer as T
from repro_torch.serve import DecodeEngine

# one intra-op thread: the reduced shapes gain nothing from more, and
# beside the other test processes idle threads spin (a reduced train
# run took 25x the CPU time with the default thread count)
torch.set_num_threads(1)

RTOL = 1e-5
XLSTM_RTOL = 5e-5          # three times the JAX xLSTM's own spread
# (arch, layers or None for .reduced()'s)
CELLS = (("xlstm-1.3b", None), ("xlstm-1.3b", 16), ("zamba2-1.2b", None),
         ("zamba2-1.2b", 5))
NAMES = ("xlstm-1.3b", "zamba2-1.2b")


@pytest.fixture
def jax_search(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", lambda: True,
                        raising=False)


def _configs(name, n_layers=None):
    cfg, jcfg = get_config(name).reduced(), jax_get_config(name).reduced()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    return cfg, jcfg


@pytest.fixture(scope="module")
def carried():
    out = {}
    for name, n_layers in CELLS:
        cfg, jcfg = _configs(name, n_layers)
        jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
        out[name, n_layers] = (cfg, jcfg, jparams, params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    return out


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float64)


def _rel(got, want):
    """max |got - want| / max |want| over the finite entries, after
    requiring the infinite entries (the -inf stabilisers) to be the same."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    inf = np.isinf(w)
    assert (np.isinf(g) == inf).all() and (g[inf] == w[inf]).all()
    if inf.all():
        return 0.0
    return float(np.abs(g[~inf] - w[~inf]).max()
                 / max(np.abs(w[~inf]).max(), 1e-30))


def _close(got, want, what, tol=RTOL):
    """Every leaf of two (nested tuples of) arrays within ``tol``."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]", tol)
        return
    assert _rel(got, want) <= tol, what


def _tol(cfg):
    return XLSTM_RTOL if cfg.block_pattern == "xlstm_7_1" else RTOL


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _x(cfg, b, s, seed):
    return np.random.RandomState(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _layer(jparams, key, *idx):
    """One layer of a stacked JAX tree, as JAX arrays and as tensors."""
    jp = jax.tree.map(lambda a: a[idx], jparams[key])
    return jp, jax.tree.map(_t, jp)


def test_the_ten_configs_equal_the_jax_ones():
    from repro.configs import all_configs as jax_all
    ours, theirs = all_configs(), jax_all()
    assert list(ours) == list(theirs) and len(ours) == 10
    for name in ours:
        for full in (False, True):
            cfg, jcfg = ours[name], theirs[name]
            if not full:
                cfg, jcfg = cfg.reduced(), jcfg.reduced()
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            assert cfg.param_count() == jcfg.param_count()
        assert get_config(name.replace("-", "_").replace(".", "_")) == ours[name]


def _spec_shapes(spec):
    """The (shape, dtype) of every leaf `init_params` allocates for
    ``T.param_spec(cfg)`` (f32 trees), by key path."""
    out = {}

    def walk(node, path, lead):
        if isinstance(node, T.Stacked):
            n = (node.n,) if isinstance(node.n, int) else tuple(node.n)
            return walk(node.spec, path, n)
        if isinstance(node, dict):
            for key, val in node.items():
                walk(val, path + (key,), lead)
            return
        out[path] = ((*lead, *node.shape), node.dtype or torch.float32)

    walk(spec, (), ())
    return out


@pytest.mark.parametrize("name", NAMES)
def test_param_tree_matches_jax_at_full_width(name):
    """The port's parameter spec at full width has every leaf of the JAX
    `init_params` tree and no other, each with its shape and dtype (w_if
    and the constants f32); the count is the JAX tree's."""
    cfg, jcfg = get_config(name), jax_get_config(name)
    want = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    got = _spec_shapes(T.param_spec(cfg))
    jleaves = {tuple(k.key for k in path): leaf for path, leaf
               in jax.tree_util.tree_leaves_with_path(want)}
    assert sorted(got) == sorted(jleaves)
    for path, leaf in jleaves.items():
        shape, dtype = got[path]
        assert shape == leaf.shape, path
        assert str(dtype).split(".")[-1] == str(leaf.dtype), path
    n = sum(int(np.prod(leaf.shape)) for leaf in jleaves.values())
    assert n == {"xlstm-1.3b": 1_312_704_848, "zamba2-1.2b": 1_105_301_632}[name]


@pytest.mark.parametrize("name", NAMES)
def test_constant_leaves_equal_the_jax_ones(name):
    """`init_params`' constant leaves (a_log, d_skip, dt_bias, if_bias, the
    sLSTM bias, the norms) equal JAX's in every stacked layer."""
    cfg, jcfg = _configs(name, 5 if name == "zamba2-1.2b" else 16)
    params = T.init_params(cfg, device="cpu", seed=3)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    consts = {"xlstm-1.3b": [("mlstm", "if_bias"), ("mlstm", "norm"),
                             ("slstm", "bias"), ("slstm", "norm"), ("ln_m",),
                             ("ln_s",)],
              "zamba2-1.2b": [(k, leaf) for k in ("mamba", "mamba_tail")
                              for leaf in ("a_log", "d_skip", "dt_bias", "norm")]
              + [("mamba_ln",), ("mamba_tail_ln",)]}[name]
    for path in consts:
        got, want = params, jparams
        for key in path:
            got, want = got[key], want[key]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   err_msg=str(path))
        assert got.dtype == torch.float32


# ---------------------------------------------------------------- the blocks


def test_mamba_chunked_matches_jax(carried):
    """S = 12 over chunks of 8 (the second padded); and the default chunk
    of 256 (one padded chunk)."""
    cfg, jcfg, jparams, _ = carried["zamba2-1.2b", None]
    jp, tp = _layer(jparams, "mamba", 1, 0)
    x = _x(cfg, 2, 12, seed=4)
    for chunk in (8, 256):
        jy, (jh, jconv) = jax_ssm.mamba_chunked(jp, jcfg, jnp.asarray(x),
                                                chunk=chunk)
        y, (h, conv) = ssm.mamba_chunked(tp, cfg, _t(x), chunk=chunk)
        _close(y, jy, f"y chunk {chunk}")
        _close(conv, jconv, f"conv chunk {chunk}")
        _close(h, jh, f"h chunk {chunk}")


def test_causal_conv_with_a_state_matches_jax(carried):
    cfg, jcfg, jparams, _ = carried["zamba2-1.2b", None]
    jp, tp = _layer(jparams, "mamba", 0, 1)
    rng = np.random.RandomState(5)
    cd = jp["conv_w"].shape[1]
    xbc = rng.standard_normal((3, 5, cd)).astype(np.float32)
    state = rng.standard_normal((3, cfg.ssm.conv_dim - 1, cd)).astype(np.float32)
    for st in (None, state):
        jout, jnew = jax_ssm._causal_conv(
            jnp.asarray(xbc), jp["conv_w"], None if st is None else jnp.asarray(st))
        out, new = ssm._causal_conv(_t(xbc), tp["conv_w"],
                                    None if st is None else _t(st))
        _close(out, jout, "out")
        np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))


def test_mamba_step_matches_jax(carried):
    """Three steps from a random state, each output and state held."""
    cfg, jcfg, jparams, _ = carried["zamba2-1.2b", 5]
    jp, tp = _layer(jparams, "mamba_tail", 0)
    rng = np.random.RandomState(6)
    h = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    hs = rng.standard_normal((2, h, cfg.ssm.head_dim, cfg.ssm.state_dim))
    conv = rng.standard_normal((2, cfg.ssm.conv_dim - 1, jp["conv_w"].shape[1]))
    jst = (jnp.asarray(hs, jnp.float32), jnp.asarray(conv, jnp.float32))
    st = (_t(hs), _t(conv))
    for i in range(3):
        x = _x(cfg, 2, 1, seed=7 + i)
        jy, jst = jax_ssm.mamba_step(jp, jcfg, jnp.asarray(x), jst)
        y, st = ssm.mamba_step(tp, cfg, _t(x), st)
        _close(y, jy, f"y step {i}")
        _close(st, jst, f"state step {i}")


def test_mlstm_chunked_matches_jax(carried):
    """S = 12 over chunks of 8 (the stabiliser carried across chunks), and
    the default chunk."""
    cfg, jcfg, jparams, _ = carried["xlstm-1.3b", None]
    jp, tp = _layer(jparams, "mlstm", 0, 3)
    x = _x(cfg, 2, 12, seed=8)
    for chunk in (8, 256):
        jy, jst = jax_xlstm.mlstm_chunked(jp, jcfg, jnp.asarray(x), chunk=chunk)
        y, st = xlstm.mlstm_chunked(tp, cfg, _t(x), chunk=chunk)
        _close(y, jy, f"y chunk {chunk}")
        _close(st, jst, f"state chunk {chunk}")


def test_mlstm_step_matches_jax(carried):
    """From the zero state with m = -inf (the cache's start), then two more
    steps."""
    cfg, jcfg, jparams, _ = carried["xlstm-1.3b", None]
    jp, tp = _layer(jparams, "mlstm", 0, 6)
    h, p = cfg.n_heads, cfg.d_model // cfg.n_heads
    jst = (jnp.zeros((2, h, p, p)), jnp.zeros((2, h, p)),
           jnp.full((2, h), -jnp.inf))
    st = tuple(_t(a) for a in jst)
    for i in range(3):
        x = _x(cfg, 2, 1, seed=9 + i)
        jy, jst = jax_xlstm.mlstm_step(jp, jcfg, jnp.asarray(x), jst)
        y, st = xlstm.mlstm_step(tp, cfg, _t(x), st)
        _close(y, jy, f"y step {i}")
        _close(st, jst, f"state step {i}")


def test_slstm_scan_and_step_match_jax(carried):
    """`slstm_scan` over 12 steps, then three `slstm_step`s from its final
    state and from the cache's start (m = -inf)."""
    cfg, jcfg, jparams, _ = carried["xlstm-1.3b", 16]
    jp, tp = _layer(jparams, "slstm", 1)
    x = _x(cfg, 2, 12, seed=12)
    jy, jst = jax_xlstm.slstm_scan(jp, jcfg, jnp.asarray(x))
    y, st = xlstm.slstm_scan(tp, cfg, _t(x))
    _close(y, jy, "scan y")
    _close(st, jst, "scan state")
    h, p = cfg.n_heads, cfg.d_model // cfg.n_heads
    zero = (jnp.zeros((2, h, p)),) * 3 + (jnp.full((2, h, p), -jnp.inf),)
    for start, (jstate, state) in (("scan", (jst, st)),
                                   ("zero", (zero, tuple(_t(a) for a in zero)))):
        for i in range(3):
            xs = _x(cfg, 2, 1, seed=13 + i)
            jy, jstate = jax_xlstm.slstm_step(jp, jcfg, jnp.asarray(xs), jstate)
            y, state = xlstm.slstm_step(tp, cfg, _t(xs), state)
            _close(y, jy, f"{start} step {i} y")
            _close(state, jstate, f"{start} step {i} state")


# ---------------------------------------------------------------- the model


def _trajectory(jparams, jcfg, tokens, steps=8):
    """The JAX prefill's logits and cache, then ``steps`` greedy decode
    steps': [(logits, cache)] and the tokens fed."""
    cache, lg = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, 48)
    out, fed = [(lg, cache)], []
    for _ in range(steps):
        tok = np.asarray(lg).argmax(-1)[:, None].astype(np.int32)
        lg, cache = JT.decode_step(jparams, jcfg, cache, jnp.asarray(tok))
        out.append((lg, cache))
        fed.append(tok)
    return out, fed


def _tokens(cfg):
    return np.random.RandomState(1).randint(1, cfg.vocab, (2, 12)).astype(
        np.int32)


@pytest.mark.parametrize("name,n_layers", CELLS)
def test_prefill_and_eight_decode_steps_match_jax(carried, name, n_layers):
    cfg, jcfg, jparams, params = carried[name, n_layers]
    tol = _tol(cfg)
    tokens = _tokens(cfg)
    want, fed = _trajectory(jparams, jcfg, tokens)
    cache, lg = T.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)}, 48)
    jlg, jcache = want[0]
    assert sorted(cache) == sorted(jcache)
    assert _rel(lg, jlg) <= tol
    for key in cache:
        _close(cache[key], jcache[key], f"prefill {key}")
    assert (cache["len"] == 12).all()
    leaves = [id(t) for t in jax.tree.leaves(cache)]
    for step, tok in enumerate(fed):
        assert (lg.numpy().argmax(-1) == tok[:, 0]).all(), step
        lg, cache = T.decode_step(params, cfg, cache, torch.from_numpy(tok))
        jlg, jcache = want[step + 1]
        assert _rel(lg, jlg) <= tol, step
    assert (lg.numpy().argmax(-1) == np.asarray(jlg).argmax(-1)).all()
    for key in cache:
        _close(cache[key], jcache[key], f"decoded {key}", tol)
    # every leaf updated in place: the same tensors as after prefill
    assert [id(t) for t in jax.tree.leaves(cache)] == leaves
    tok = np.asarray(jlg).argmax(-1)[:, None].astype(np.int32)
    hid, _ = T.decode_step(params, cfg, cache, torch.from_numpy(tok),
                           return_hidden=True)
    jhid, _ = JT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                             return_hidden=True)
    assert _rel(hid, jhid) <= tol


def test_xlstm_amplifies_rounding_past_1e5(carried):
    """Why the xLSTM's model tolerance is XLSTM_RTOL: the JAX model against
    itself, its embedding multiplied by 1 +- 2^-24 (seeded signs), on the
    same tokens, moves its logits or states by more than 1e-5 of their
    largest at 16 layers; XLSTM_RTOL is at least twice that spread."""
    cfg, jcfg, jparams, _ = carried["xlstm-1.3b", 16]
    emb = np.asarray(jparams["embed"])
    signs = np.random.RandomState(0).choice([-1.0, 1.0], emb.shape)
    moved = dict(jparams, embed=jnp.asarray(
        (emb * (1 + signs * 2.0 ** -24)).astype(np.float32)))
    tokens = _tokens(cfg)
    base, fed = _trajectory(jparams, jcfg, tokens)
    cache, lg = JT.prefill(moved, jcfg, {"tokens": jnp.asarray(tokens)}, 48)
    spread = [_rel(lg, base[0][0])]
    for step, tok in enumerate(fed):
        lg, cache = JT.decode_step(moved, jcfg, cache, jnp.asarray(tok))
        spread.append(_rel(lg, base[step + 1][0]))
    spread += [_rel(a, b) for a, b in zip(jax.tree.leaves(cache),
                                          jax.tree.leaves(base[-1][1]))
               if np.asarray(b).dtype == np.float32]
    assert RTOL < max(spread) <= XLSTM_RTOL / 2, max(spread)


# ---------------------------------------------------------------- serving


def _prompts(cfg, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, cfg.vocab, size=8 if i % 2 else 12).astype(np.int32)
            for i in range(n)]


@pytest.mark.parametrize("mode", ["exact", "promips"])
@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_jax(carried, jax_search, name, mode):
    """Six requests of two prompt lengths through three slots: every
    request's tokens and the engines' counters equal; every cache leaf
    within RTOL; the batch axes equal to the JAX engine's."""
    cfg, jcfg, jparams, params = carried[name, None]
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
        _close(te.cache[key], je.cache[key], key, _tol(cfg))
    assert te._batch_axes == je._batch_axes
    if name == "xlstm-1.3b":
        assert te._batch_axes["slstm"] == (1, 1, 1, 1)


def _jax_params_for(monkeypatch):
    """Make the port's `init_params` return the JAX parameters of the same
    config (`init_params(PRNGKey(0), cfg)`), carried across."""
    def init_params(cfg, *, seed=0, device="cuda", **_):
        jcfg = jax_get_config(cfg.name).reduced()
        jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
        return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device)
    monkeypatch.setattr(T, "init_params", init_params)


@pytest.mark.parametrize("name,mode", [("xlstm-1.3b", "promips"),
                                       ("zamba2-1.2b", "exact")])
def test_launch_serve_main_matches_jax(jax_search, monkeypatch, capsys, name,
                                       mode):
    argv = ["--arch", name, "--reduced", "--requests", "5", "--slots", "2",
            "--prompt-len", "10", "--max-new", "4", "--max-len", "64",
            "--logits-mode", mode]
    jreqs = jax_serve.main(argv)
    _jax_params_for(monkeypatch)
    reqs = launch_serve.main(argv + ["--device", "cpu"])
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert capsys.readouterr().out.count("served 5 requests") == 2


def test_loss_fn_names_the_training_item(carried):
    """The recurrent patterns train (ROADMAP Queue 1 item 18): a finite
    loss and finite gradients for both configs (the values against JAX are
    `tests/test_torch_recurrent_train.py`'s). zamba2 at S 12 is where the
    SSD's unmasked exp overflowed into a NaN gradient."""
    from repro_torch import tree as tree_lib
    for name in NAMES:
        cfg, _, _, params = carried[name, None]
        leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(params)]
        tokens = torch.from_numpy(_tokens(cfg)).long()
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
        loss, _ = T.loss_fn(tree_lib.unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        assert bool(torch.isfinite(loss))
        assert all(bool(torch.isfinite(g).all()) for g in grads), name
