"""The port in bf16, the JAX package's model dtype (`launch/specs.py`
`model_dtype`), against the JAX package on the CPU at the configs'
`.reduced()` sizes, with the JAX parameters of
`init_params(PRNGKey(0), cfg, dtype=jnp.bfloat16)` carried across by
`convert.params_from_jax`.

- The converter carries every bf16 (and f32) leaf bit for bit, for the ten
  configs.
- `decode_attention`'s plain version in bf16 at dh 32, 64, 120 and 128:
  the output bf16 and within one bf16 ulp of JAX's `ref.decode_attention_ref`
  and of the Pallas kernel in interpret mode; in f32 at dh 120 within the
  f32 bound of `tests/test_torch_model.py` (1e-5).
- Each family (dense, SWA, q/k norms, MoE, vision, encoder-decoder, zamba2,
  xLSTM): `prefill` and eight `decode_step`s, every run fed JAX's bf16
  greedy tokens; a `DecodeEngine` in both logit modes; and two
  `make_train_step` steps (tinyllama-1.1b and xlstm-1.3b, 2 microbatches).
- Checkpoints of bf16 trees: the port writes the JAX package's bytes, and
  each package's save restores in the port bit for bit.

The rule for bf16 results (logits, cache leaves, loss, grad norm, every
leaf of params / mu / nu). JAX's own bf16 error is the larger of two
distances of its bf16 result: from the same computation in f32 on the same
bf16 weights, and from the same bf16 computation with the embedding moved by
one bf16 ulp (scaled by 1 + 2^-7): phase 12a's rule (`chip_smoke.py`) in
bf16 form; along the decode steps, the largest such error of the logits
(or of a cache leaf) at this step or an earlier one, since the state
carries every earlier step's rounding (a single step's own error is one
noisy sample: zamba2's Mamba state measured 0.025, 0.025, then 0.012 at
the next step, where the port lay 0.025 from JAX). The port's result lies
within twice that of JAX's bf16 result (``max |port - jax| / max |jax|``,
over the finite entries; infinities at the same places), plus 1e-6. A greedy token may differ from JAX's only where
JAX's top two logits lie within that tolerance of each other. The train
steps each start from the JAX state carried across (as phase 12a's
recurrent cells do): two free-running bf16 trajectories part by more than
twice one step's own error after one step (measured: up to 3.4x on
tinyllama, 8.8x on the xLSTM). Each margin is printed (``-s``).

The sLSTM's h in the JAX cache takes the cell's bf16 after a decode step;
the port's cache buffer keeps its f32 allocation and holds the same values,
so the cache leaves are compared as values. JAX's `checkpoint.restore`
cannot read a bf16 leaf (numpy writes JAX's bfloat16 as raw ``|V2``
records, which `jnp.asarray` refuses, its own saves included): the JAX side
of a port save is read as that restore would read it with the manifest's
dtype applied.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed import checkpoint as jax_ckpt
from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.models import transformer as JT
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.train import loop as jax_loop
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.data import synthetic
from repro_torch.distributed import checkpoint as ckpt_lib
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.serve import DecodeEngine
from repro_torch.train import loop

# one intra-op thread: the reduced shapes gain nothing from more, and
# beside the other test processes idle threads spin
torch.set_num_threads(1)

BF16 = jnp.bfloat16
FAMILIES = ("tinyllama-1.1b", "h2o-danube-3-4b", "qwen3-32b",
            "qwen2-moe-a2.7b", "internvl2-2b", "whisper-base", "zamba2-1.2b",
            "xlstm-1.3b")
TRAIN = ("tinyllama-1.1b", "xlstm-1.3b")
MOVE = 1 + 2.0 ** -7       # one bf16 ulp at 1: the embedding moved by it
FLOOR = 1e-6


@pytest.fixture
def jax_search(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", lambda: True,
                        raising=False)


def _f64(x):
    if torch.is_tensor(x):
        return x.detach().double().numpy()
    return np.asarray(x, dtype=np.float64)


def _rel(got, want) -> float:
    """max |got - want| / max |want| over the finite entries; the
    non-finite entries must be the same values at the same places."""
    g, w = _f64(got), _f64(want)
    fg, fw = np.isfinite(g), np.isfinite(w)
    assert (fg == fw).all() and (g[~fg] == w[~fw]).all()
    if not fw.any():
        return 0.0
    return float(np.abs(g[fw] - w[fw]).max() / max(np.abs(w[fw]).max(), 1e-30))


def _within(label, port, j16, *others, seen=None) -> float:
    """Hold ``port`` to JAX's bf16 ``j16`` by the module's rule, ``others``
    the results that measure JAX's own error; with ``seen`` (a dict), the
    largest own error of ``label``'s series so far (a decode step's state
    carries every earlier step's rounding). Returns the tolerance."""
    own = max(_rel(o, j16) for o in others)
    if seen is not None:
        series = label.split(":")[0]
        own = seen[series] = max(own, seen.get(series, 0.0))
    err, tol = _rel(port, j16), 2 * own + FLOOR
    print(f"{label}: port-jax {err:.3g}, JAX's own bf16 error {own:.3g}, "
          f"margin {err / tol:.3f} of the tolerance")
    assert err <= tol, (label, err, tol)
    return tol


def _bits(x) -> np.ndarray:
    """The bit patterns of a leaf (16-bit for bf16)."""
    if torch.is_tensor(x):
        x = x.detach().reshape(-1)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint8)
    x = np.asarray(x).reshape(-1)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x.view(np.uint8)


def _moved(jparams):
    return dict(jparams, embed=(jparams["embed"] * MOVE).astype(BF16))


def _to_f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == BF16 else a, tree)


# ---------------------------------------------------------------- converter


@pytest.mark.parametrize("name", ARCH_IDS)
def test_params_from_jax_carries_bf16_bit_for_bit(name):
    cfg, jcfg = get_config(name).reduced(), jax_get_config(name).reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=BF16)
    params = params_from_jax(jparams, cfg, device="cpu")
    jleaves, leaves = jax.tree_util.tree_leaves(jparams), tree_lib.leaves(params)
    assert len(jleaves) == len(leaves)
    assert any(t.dtype == torch.bfloat16 for t in leaves)
    for j, t in zip(jleaves, leaves):
        assert tree_lib.dtype_name(t) == str(j.dtype)
        assert tuple(t.shape) == j.shape
        assert np.array_equal(_bits(t), _bits(j))


# ---------------------------------------------------------------- kernel


@pytest.mark.parametrize("dh", [32, 64, 120, 128])
def test_decode_attention_plain_bf16_within_one_ulp_of_jax(dh):
    b, kh, g, s, lens = 3, 2, 4, 300, [300, 1, 150]
    rng = np.random.RandomState(dh)
    arrays = [rng.standard_normal(shape).astype(np.float32).astype(
        ml_dtypes.bfloat16) for shape in ((b, kh, g, dh), (b, s, kh, dh),
                                          (b, s, kh, dh))]
    cache_len = np.array(lens, np.int32)
    q, k, v = (tree_lib.leaf_from_numpy(a) for a in arrays)
    got = ops.decode_attention(q, k, v, torch.from_numpy(cache_len))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    for want in (jax_ref.decode_attention_ref(jq, jk, jv, jnp.asarray(cache_len)),
                 pallas_decode(jq, jk, jv, jnp.asarray(cache_len),
                               interpret=True)):
        assert want.dtype == BF16
        w = np.asarray(want, dtype=np.float64)
        top = np.maximum(np.abs(w), np.abs(_f64(got)))
        ulp = np.ldexp(1.0, np.frexp(top)[1] - 8)
        ulps = np.abs(_f64(got) - w) / ulp
        print(f"dh {dh}: {ulps.max():.3g} bf16 ulps from JAX")
        assert ulps.max() <= 1.0


def test_decode_attention_plain_f32_at_dh_120():
    b, kh, g, dh, s, lens = 3, 2, 4, 120, 300, [300, 1, 150]
    rng = np.random.RandomState(5)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, kh, g, dh), (b, s, kh, dh), (b, s, kh, dh)))
    cache_len = np.array(lens, np.int32)
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               torch.from_numpy(cache_len))
    for want in (jax_ref.decode_attention_ref(q, k, v, cache_len),
                 pallas_decode(q, k, v, cache_len, interpret=True)):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


# ---------------------------------------------------------------- families


def _batch(cfg, b, s, seed):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(1, cfg.vocab, (b, s)).astype(np.int32)}
    key = T.frontend_key(cfg)
    if key is not None:
        batch[key] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype(ml_dtypes.bfloat16)
    return batch


def _jax_batch(batch, dtype):
    return {k: jnp.asarray(v).astype(dtype) if v.dtype.name == "bfloat16"
            else jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _carried(name):
    cfg, jcfg = get_config(name).reduced(), jax_get_config(name).reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=BF16)
    return cfg, jcfg, jparams, params_from_jax(jparams, cfg, device="cpu")


def _greedy_ok(label, port, j16, tol):
    """The port's greedy tokens equal JAX's, or JAX's top two logits lie
    within ``tol`` (relative to max |logit|) where they differ."""
    p, j = _f64(port), _f64(j16)
    for row in np.nonzero(p.argmax(-1) != j.argmax(-1))[0]:
        top2 = np.sort(j[row])[-2:]
        gap = (top2[1] - top2[0]) / np.abs(j).max()
        print(f"{label}: row {row} token {p[row].argmax()} vs JAX's "
              f"{j[row].argmax()}, JAX's top two {gap:.3g} apart (tol {tol:.3g})")
        assert gap <= tol, (label, row, gap, tol)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_eight_decode_steps_match_jax_bf16(name):
    cfg, jcfg, jparams, params = _carried(name)
    runs = {"bf16": jparams, "f32": _to_f32(jparams), "moved": _moved(jparams)}
    batch = _batch(cfg, 2, 12, seed=1)
    prefill = jax.jit(lambda p, b: JT.prefill(p, jcfg, b, 48))
    decode = jax.jit(lambda p, c, t: JT.decode_step(p, jcfg, c, t))
    jout = {k: prefill(p, _jax_batch(batch, jnp.float32 if k == "f32" else BF16))
            for k, p in runs.items()}
    tbatch = {k: tree_lib.leaf_from_numpy(v) for k, v in batch.items()}
    cache, lg = T.prefill(params, cfg, tbatch, 48)
    assert params["embed"].dtype == torch.bfloat16
    assert lg.dtype == torch.float32

    seen = {}

    def check(step, cache, lg):
        (jc, jl), (fc, fl), (mc, ml) = jout["bf16"], jout["f32"], jout["moved"]
        tol = _within(f"{name} logits: {step}", lg, jl, fl, ml, seen=seen)
        _greedy_ok(f"{name} {step}", lg, jl, tol)
        leaves = [t for key in sorted(cache) for t in (
            cache[key] if isinstance(cache[key], tuple) else (cache[key],))]
        jleaves = [jax.tree_util.tree_leaves(c) for c in (jc, fc, mc)]
        assert len(leaves) == len(jleaves[0])
        for i, (t, a, f, m) in enumerate(zip(leaves, *jleaves)):
            if not t.is_floating_point():
                assert np.array_equal(t.numpy(), np.asarray(a)), i
                continue
            # the sLSTM's h: JAX's turns bf16, the port's buffer stays f32
            assert tree_lib.dtype_name(t) == str(a.dtype) or (
                t.dtype == torch.float32 and a.dtype == BF16), i
            _within(f"{name} cache leaf {i}: {step}", t, a, f, m, seen=seen)

    check("prefill", cache, lg)
    tok = np.asarray(jout["bf16"][1]).argmax(-1)[:, None].astype(np.int32)
    for step in range(8):
        jout = {k: decode(runs[k], jout[k][0], jnp.asarray(tok))[::-1]
                for k in runs}
        lg, cache = T.decode_step(params, cfg, cache, torch.from_numpy(tok))
        check(f"step {step}", cache, lg)
        tok = np.asarray(jout["bf16"][1]).argmax(-1)[:, None].astype(np.int32)


def _traffic(cfg):
    rng = np.random.RandomState(1)
    return [rng.randint(1, cfg.vocab, size=8 if i % 2 else 12).astype(
        np.int32) for i in range(8)]


def _engines_bf16(mode):
    cfg, jcfg, jparams, params = _carried("tinyllama-1.1b")
    kw = dict(batch_slots=3, max_len=64, result_cache=0, max_refill=None,
              logits_mode=mode)
    return cfg, JaxEngine(jparams, jcfg, **kw), DecodeEngine(
        params, cfg, device="cpu", **kw)


def test_engine_bf16_exact_matches_jax():
    """`DecodeEngine` on bf16 parameters (a bf16 cache, f32 logits) against
    the JAX engine on the same bf16 parameters: the same tokens and
    counters."""
    cfg, je, te = _engines_bf16("exact")
    assert te.cache["k"].dtype == torch.bfloat16
    out = []
    for eng in (je, te):
        reqs = [eng.submit(p, max_new_tokens=6) for p in _traffic(cfg)]
        eng.run()
        out.append([r.out_tokens for r in reqs])
    assert out[1] == out[0]
    for counter in ("steps", "prefill_calls"):
        assert getattr(te, counter) == getattr(je, counter), counter


def test_engine_bf16_promips_searches_as_jax(jax_search):
    """The promips mode on bf16 parameters, its vocab index built in f32
    from the bf16 embedding as the JAX engine's: the port's search of each
    hidden batch the JAX engine searched (its bf16 rows) returns the JAX
    search's ids and pages. (The two
    engines' own hidden states differ by bf16 rounding, which an
    approximate search may turn into another token: the prefill's
    summation order already moves a hidden entry by 1.5 ulp.)"""
    cfg, je, te = _engines_bf16("promips")
    seen = []
    inner = je.index.search

    def search(queries, k=None, **opts):
        res = inner(queries, k=k, **opts)
        seen.append((np.asarray(queries, np.float32), k, opts, res))
        return res

    je.index.search = search
    reqs = [je.submit(p, max_new_tokens=6) for p in _traffic(cfg)]
    je.run()
    assert seen and all(len(r.out_tokens) > 1 for r in reqs)
    rt = te._tier_runtime()
    for queries, k, opts, res in seen:
        # as the port engine passes them (bf16), and in f32
        q16 = torch.from_numpy(queries).bfloat16()
        assert torch.equal(q16.float(), torch.from_numpy(queries))
        for q in (q16, q16.float()):
            got = te.index.search(q, k=k, runtime=rt)
            assert np.array_equal(np.asarray(got.ids), np.asarray(res.ids))
            assert got.stats["pages"] == res.stats["pages"]


# ---------------------------------------------------------------- train


@pytest.mark.parametrize("name", TRAIN)
def test_train_step_bf16_matches_jax(name):
    """Two steps of `make_train_step` on bf16 parameters (f32 gradient
    accumulation over 2 microbatches, f32 moments, the update in f32 and
    cast back), each from the JAX state carried across, held by the
    module's rule leaf by leaf."""
    kw = dict(lr=1e-3, warmup=2, total_steps=20, microbatches=2, remat="full")
    cfg, jcfg, jparams, _ = _carried(name)
    jt = jax_loop.TrainCfg(**kw)
    jstate = jax_loop.init_state(jparams, jt)
    jstep = jax.jit(jax_loop.make_train_step(jcfg, jt))
    step = loop.make_train_step(cfg, loop.TrainCfg(**kw))
    stream = synthetic.TokenStream(vocab=cfg.vocab, batch=4, seq=64, seed=0)
    for i in range(2):
        batch = stream.batch_at(i)
        state = train_state_from_jax(jstate, cfg, "cpu")
        f32 = jstate._replace(params=_to_f32(jstate.params))
        moved = jstate._replace(params=_moved(jstate.params))
        (jstate, jm), (fs, fm), (ms, mm) = (jstep(s, batch)
                                            for s in (jstate, f32, moved))
        new, m = step(state, batch)
        for key in ("loss", "grad_norm"):
            _within(f"{name} step {i} {key}", m[key], jm[key], fm[key], mm[key])
        names = [".".join(str(getattr(k, "key", k)) for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(
                     jstate.params)[0]]
        for part in ("params", "mu", "nu"):
            pick = ((lambda s: s.params) if part == "params"
                    else (lambda s, part=part: getattr(s.opt, part)))
            leaves = tree_lib.leaves(pick(new))
            if part != "params":
                assert all(t.dtype == torch.float32 for t in leaves)
            for n, t, a, f, mv in zip(names, leaves, *(
                    jax.tree_util.tree_leaves(pick(s))
                    for s in (jstate, fs, ms))):
                assert tree_lib.dtype_name(t) == str(a.dtype), n
                _within(f"{name} step {i} {part} {n}", t, a, f, mv)


# ---------------------------------------------------------------- checkpoints


def _jax_state():
    cfg, jcfg, jparams, _ = _carried("tinyllama-1.1b")
    jstate = jax_loop.init_state(jparams, jax_loop.TrainCfg())
    return cfg, jstate._replace(step=jnp.int32(3),
                                opt=jstate.opt._replace(count=jnp.int32(3)))


def test_port_bf16_save_is_the_jax_save_byte_for_byte(tmp_path):
    """A port save of a bf16 train state writes what the JAX package
    writes for the same state: the manifest (tree, dtypes with
    ``"bfloat16"``, shapes) and every leaf's dtype and bytes; read with the
    manifest's dtypes, it is the JAX state bit for bit."""
    cfg, jstate = _jax_state()
    state = train_state_from_jax(jstate, cfg, "cpu")
    ckpt_lib.save(str(tmp_path / "port"), 3, state)
    jax_ckpt.save(str(tmp_path / "jax"), 3, jstate)
    manifests = [json.load(open(tmp_path / d / "step_3" / "manifest.json"))
                 for d in ("port", "jax")]
    assert manifests[0] == manifests[1]
    assert "bfloat16" in manifests[0]["dtypes"]
    with np.load(tmp_path / "port" / "step_3" / "arrays.npz") as p, \
            np.load(tmp_path / "jax" / "step_3" / "arrays.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for key in j.files:
            assert p[key].dtype == j[key].dtype and p[key].tobytes() == j[key].tobytes()
        read = [p[f"leaf_{i}"].view(ml_dtypes.bfloat16) if dt == "bfloat16"
                else p[f"leaf_{i}"] for i, dt in enumerate(manifests[0]["dtypes"])]
    for a, b in zip(read, jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(np.asarray(b)))


def test_jax_restore_cannot_read_its_own_bf16_save(tmp_path):
    """The fault the port's reader works around: numpy writes JAX's
    bfloat16 leaves as raw ``|V2`` records, and the JAX `restore` hands
    them to `jnp.asarray`, which refuses them."""
    _, jstate = _jax_state()
    jax_ckpt.save(str(tmp_path), 3, jstate)
    with pytest.raises(TypeError, match="V2"):
        jax_ckpt.restore(str(tmp_path), 3, jstate)


def test_jax_bf16_save_restores_in_the_port_bit_for_bit(tmp_path):
    cfg, jstate = _jax_state()
    jax_ckpt.save(str(tmp_path), 3, jstate)
    target = train_state_from_jax(jstate, cfg, "cpu")
    target = tree_lib.map(torch.zeros_like, target)
    got = ckpt_lib.restore(str(tmp_path), 3, target, device="cpu")
    leaves = tree_lib.leaves(got)
    assert any(t.dtype == torch.bfloat16 for t in leaves)
    for t, a in zip(leaves, jax.tree_util.tree_leaves(jstate)):
        assert tree_lib.dtype_name(t) == str(a.dtype)
        assert np.array_equal(_bits(t), _bits(np.asarray(a)))
    # and the port's own bf16 save round-trips
    ckpt_lib.save(str(tmp_path / "again"), 3, got)
    back = ckpt_lib.restore(str(tmp_path / "again"), 3, target, device="cpu")
    assert all(torch.equal(_t(a), _t(b)) for a, b in zip(
        tree_lib.leaves(back), leaves))


def _t(x):
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def test_init_params_bf16_fills_each_leaf_in_bf16():
    """`init_params(dtype=bf16)`: every leaf bf16 but the constant f32 ones
    the JAX tree keeps f32, finite, with the JAX tree's dtypes."""
    for name in ARCH_IDS:
        cfg, jcfg = get_config(name).reduced(), jax_get_config(name).reduced()
        params = T.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
        want = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg,
                                                     dtype=BF16))
        for t, w in zip(tree_lib.leaves(params), jax.tree_util.tree_leaves(want)):
            assert tree_lib.dtype_name(t) == str(w.dtype) and tuple(t.shape) == w.shape
            assert bool(torch.isfinite(t.float()).all())
