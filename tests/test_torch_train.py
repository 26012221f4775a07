"""The port's training path (plain PyTorch on the CPU) against the JAX
package, on the same seeded numpy inputs and on parameters carried across
by `convert.params_from_jax` / `train_state_from_jax`.

Tolerances, each relative (``max |got - want| / max |want|``, per leaf for
trees) unless a test says otherwise:
- `TokenStream.batch_at` and `lm_batch`: bit for bit;
- `cosine_schedule`, `clip_by_global_norm`, three `adamw_update` steps on
  the same gradients: 1e-6 (both compute in f32; `pow` and the global
  sum may differ in the last ulp);
- `compress_grads` over three rounds on the same gradients: the int8 codes
  exact, residuals within 1e-7 of what was quantized;
- the flash attention (S 40, block 16: a ragged last block; window 0 and
  8; H 4, KH 2): output and the gradients of q, k, v within 1e-5 of
  `jax.grad` through the JAX `_flash_causal`, and of torch autograd through
  a naive softmax attention;
- `loss_fn` and every gradient leaf against `jax.value_and_grad` of the
  JAX `loss_fn` under the same remat policy, the four reduced dense
  configs: 1e-5 (GEMMs sum in other orders in the two frameworks);
- three `make_train_step` steps against the jitted JAX step (microbatches
  1 and 2): loss, grad norm and lr 1e-5; the moments 1e-5; the
  parameters 1e-5 beyond `parity.adam_allowance` (Adam's normalization
  multiplies a small element's gradient error; the count of elements that
  use it is printed). With compression each of the three steps starts from
  the JAX state (an int8 flip moves a parameter by up to a step, and that
  difference would then grow); elements that flip are counted and each
  must lie within `parity.FLIP_MARGIN` of the rounding boundary; the rest
  within 1e-5 (a residual relative to what was quantized);
- the three new configs' reduced prefill and decode logits against the
  JAX `transformer`: 1e-5.
TF32 plays no part on the CPU.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import synthetic as jax_synthetic
from repro.distributed import checkpoint as jax_ckpt
from repro.distributed import compression as jax_compression
from repro.models import attention as jax_attention
from repro.models import transformer as JT
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.data import synthetic
from repro_torch.distributed import compression
from repro_torch.launch import train as launch_train
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.train import loop, optimizer, parity

# one intra-op thread: the reduced shapes gain nothing from more, and
# beside the other test processes idle threads spin (a reduced train
# run took 25x the CPU time with the default thread count)
torch.set_num_threads(1)

DENSE = ("tinyllama-1.1b", "phi4-mini-3.8b", "qwen3-32b", "h2o-danube-3-4b")
NEW = ("phi4-mini-3.8b", "qwen3-32b", "h2o-danube-3-4b")
RTOL = 1e-5
RTOL_OPT = 1e-6


def _rel(got, want):
    return parity.rel(got, want)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("seed,step,host,n_hosts", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 123, 1, 2), (11, 5, 3, 4), (2**20, 99, 0, 2)])
def test_token_stream_bit_for_bit(seed, step, host, n_hosts):
    kw = dict(vocab=512, batch=8, seq=33, seed=seed)
    got = synthetic.TokenStream(**kw).batch_at(step, host, n_hosts)
    want = jax_synthetic.TokenStream(**kw).batch_at(step, host, n_hosts)
    assert set(got) == set(want) == {"tokens", "labels"}
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-2b",
                                  "whisper-base"])
def test_lm_batch_bit_for_bit(arch):
    """The text fields and the vision patches / audio frames (the port's
    model takes text only; the batch is the JAX package's all the same)."""
    cfg = jax_get_config(arch).reduced()
    shape = dataclasses.make_dataclass("S", ["global_batch", "seq_len"])(4, 16)
    for step, seed in ((0, 0), (3, 5)):
        got = synthetic.lm_batch(cfg, shape, step, seed)
        want = jax_synthetic.lm_batch(cfg, shape, step, seed)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------- optimizer


def test_cosine_schedule_matches_jax():
    lr = optimizer.cosine_schedule(3e-4, 10, 150)
    jlr = jax_opt.cosine_schedule(3e-4, 10, 150)
    steps = np.arange(0, 201)
    got = lr(torch.from_numpy(steps.astype(np.int32))).numpy()
    want = np.asarray(jlr(jnp.asarray(steps, jnp.int32)))
    assert _rel(got, want) <= RTOL_OPT
    for s in (0, 9, 10, 11, 150, 200):
        assert _rel(float(lr(s)), float(jlr(s))) <= RTOL_OPT


def _tree(rng, scale=1.0):
    """A tree with a stacked (L, d) norm leaf, a 1-D leaf, a matrix and a
    stacked matrix: the shapes the weight-decay rule tells apart."""
    return {"blocks": {"ln1": 1.0 + scale * rng.standard_normal((3, 8)).astype(np.float32),
                       "w": scale * rng.standard_normal((3, 8, 4)).astype(np.float32)},
            "final_norm": 1.0 + scale * rng.standard_normal((8,)).astype(np.float32),
            "embed": scale * rng.standard_normal((16, 8)).astype(np.float32)}


def test_clip_by_global_norm_matches_jax():
    rng = np.random.RandomState(0)
    g = _tree(rng, 0.5)
    for max_norm in (1.0, 100.0):
        got, gnorm = optimizer.clip_by_global_norm(tree_lib.map(_t, g), max_norm)
        want, jnorm = jax_opt.clip_by_global_norm(g, max_norm)
        assert _rel(gnorm, jnorm) <= RTOL_OPT
        for a, b in zip(tree_lib.leaves(got), jax.tree_util.tree_leaves(want)):
            assert _rel(a, b) <= RTOL_OPT


def test_adamw_update_three_steps_matches_jax():
    """Weight decay on every leaf of ndim >= 2, the stacked (L, d) norm
    included, and none on the 1-D leaf; the count before the schedule."""
    rng = np.random.RandomState(1)
    params = _tree(rng)
    lr = optimizer.cosine_schedule(1e-2, 2, 10)
    jlr = jax_opt.cosine_schedule(1e-2, 2, 10)
    p, st = tree_lib.map(_t, params), optimizer.adamw_init(tree_lib.map(_t, params))
    jp, jst = params, jax_opt.adamw_init(params)
    for i in range(3):
        g = _tree(rng, 0.3 * (i + 1))
        p, st, gnorm = optimizer.adamw_update(tree_lib.map(_t, g), st, p, lr=lr)
        jp, jst, jnorm = jax_opt.adamw_update(g, jst, jp, lr=jlr)
        assert int(st.count) == int(jst.count) == i + 1
        assert _rel(gnorm, jnorm) <= RTOL_OPT
        for got, want in ((p, jp), (st.mu, jst.mu), (st.nu, jst.nu)):
            for a, b in zip(tree_lib.leaves(got), jax.tree_util.tree_leaves(want)):
                assert _rel(a, b) <= RTOL_OPT, i
    # the stacked norm decays, the 1-D norm does not: with zero gradients
    zero = tree_lib.map(lambda x: torch.zeros_like(x), p)
    p2, _, _ = optimizer.adamw_update(zero, optimizer.adamw_init(p), p, lr=0.1)
    assert not torch.equal(p2["blocks"]["ln1"], p["blocks"]["ln1"])
    assert torch.equal(p2["final_norm"], p["final_norm"])
    # in place: the same values, in the given tensors
    q = tree_lib.map(torch.clone, p)
    st_q = optimizer.adamw_init(q)
    g = tree_lib.map(_t, _tree(rng, 0.1))
    want_p, want_st, _ = optimizer.adamw_update(g, st_q, q, lr=lr)
    got_p, got_st, _ = optimizer.adamw_update(g, st_q, q, lr=lr, inplace=True)
    assert got_p["embed"] is q["embed"] and got_st.mu["embed"] is st_q.mu["embed"]
    got = tree_lib.leaves(got_p) + tree_lib.leaves(got_st)
    want = tree_lib.leaves(want_p) + tree_lib.leaves(want_st)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_compress_grads_three_rounds_matches_jax():
    rng = np.random.RandomState(2)
    params = _tree(rng)
    ef = compression.error_feedback_init(tree_lib.map(_t, params))
    jef = jax_compression.error_feedback_init(params)
    for _ in range(3):
        g = _tree(rng, 0.2)
        for a, r, jr in zip(tree_lib.leaves(g), tree_lib.leaves(ef.residual),
                            jax.tree_util.tree_leaves(jef.residual)):
            x = _t(a) + r
            q, scale = compression._quant_int8(x)
            jq, jscale = jax_compression._quant_int8(jnp.asarray(a) + jr)
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            assert q.dtype == torch.int8 and float(scale) == float(jscale)
        deq, ef = compression.compress_grads(tree_lib.map(_t, g), ef)
        jdeq, jef = jax_compression.compress_grads(g, jef)
        for a, b, c in zip(tree_lib.leaves(ef.residual),
                           jax.tree_util.tree_leaves(jef.residual),
                           jax.tree_util.tree_leaves(jdeq)):
            quantized = np.abs(np.asarray(b) + np.asarray(c)).max()
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-7 * quantized
        for a, b in zip(tree_lib.leaves(deq), jax.tree_util.tree_leaves(jdeq)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_int8_psum_one_rank_equals_jax_shard_map():
    """`int8_psum` over a mesh of one rank against the JAX one under
    ``shard_map`` on one device: the int8 round trip of each leaf, bit for
    bit (the four-rank case: `tests/test_torch_distributed.py`)."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as JP
    from repro_torch.launch.mesh import make_host_mesh
    rng = np.random.RandomState(3)
    tree = {"a": rng.standard_normal((8, 16)).astype(np.float32),
            "b": {"c": (rng.standard_normal(5) * 1e-3).astype(np.float32)}}
    jmesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    want = shard_map(lambda t: jax_compression.int8_psum(t, "data"), mesh=jmesh,
                     in_specs=JP(), out_specs=JP(), check_rep=False)(tree)
    got = compression.int8_psum(tree_lib.map(_t, tree), "data", make_host_mesh())
    for a, b in zip(tree_lib.leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------- attention


def _naive_attention(q, k, v, window):
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    kk = k.repeat_interleave(g, dim=2)
    vv = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, kk) * dh ** -0.5
    pos = torch.arange(s)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vv)


@pytest.mark.parametrize("window", [0, 8])
def test_flash_attention_backward_matches_jax(window):
    rng = np.random.RandomState(3 + window)
    b, s, h, kh, dh = 2, 40, 4, 2, 16
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, dh)).astype(np.float32)
    w = rng.standard_normal((b, s, h, dh)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jax_attention._flash_causal(q, k, v, window=window,
                                                   block=16) * w)

    jout = jax_attention._flash_causal(q, k, v, window=window, block=16)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = attention._flash_causal(tq, tk, tv, window=window, block=16)
    (out * _t(w)).sum().backward()
    assert _rel(out.detach(), jout) <= RTOL
    for t, jg in zip((tq, tk, tv), jgrads):
        assert _rel(t.grad, jg) <= RTOL
    # against autograd through a naive attention
    nq, nk, nv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    ref = _naive_attention(nq, nk, nv, window)
    (ref * _t(w)).sum().backward()
    assert _rel(out.detach(), ref.detach()) <= RTOL
    for t, n in zip((tq, tk, tv), (nq, nk, nv)):
        assert _rel(t.grad, n.grad) <= RTOL
    # only (q, k, v, out, lse) are kept: nothing of S x S, nothing per block
    assert len(saved) == 5, saved
    assert max(int(np.prod(sh)) for sh in saved) == b * s * h * dh
    assert (b, kh, h // kh, s) in saved


# ---------------------------------------------------------------- loss


@pytest.fixture(scope="module")
def carried():
    out = {}
    for name in DENSE:
        cfg, jcfg = get_config(name).reduced(), jax_get_config(name).reduced()
        jparams = JT.init_params(jax.random.PRNGKey(1), jcfg)
        out[name] = (cfg, jcfg, jparams, params_from_jax(jparams, cfg, "cpu"))
    return out


def _port_grads(params, cfg, batch, remat):
    leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(params)]
    tb = {k: _t(v) for k, v in batch.items()}
    loss, metrics = T.loss_fn(tree_lib.unflatten(params, leaves), cfg, tb,
                              remat=remat)
    return loss.detach(), metrics, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("name", DENSE)
def test_loss_fn_and_grads_match_jax(carried, name, remat):
    """48 tokens: longer than h2o-danube's reduced window (32), so the SWA
    mask runs through the backward; qwen3 has q/k norms and an untied
    unembed; labels -1 are ignored."""
    cfg, jcfg, jparams, params = carried[name]
    batch = synthetic.TokenStream(vocab=cfg.vocab, batch=2, seq=48,
                                  seed=7).batch_at(0)
    batch["labels"][0, :5] = -1
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b, remat=remat), has_aux=True))(
            jparams, batch)
    loss, metrics, grads = _port_grads(params, cfg, batch, remat)
    assert _rel(loss, jloss) <= RTOL and _rel(metrics["loss"].detach(), jm["loss"]) <= RTOL
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for leaf, g, jg in zip(parity.leaf_names(params), grads, jleaves):
        assert _rel(g, jg) <= RTOL, leaf


def test_remat_modes_agree_and_dots_keeps_the_weight_gemms(carried):
    """The three policies give the same loss and gradients bit for bit;
    `dots` recomputes no 2-D matmul in the backward, `full` recomputes
    the layer GEMMs whose outputs the backward reads (six of seven: the
    non-reentrant checkpoint stops before the last, ``w_down``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    cfg, _, _, params = carried["qwen3-32b"]
    batch = synthetic.TokenStream(vocab=cfg.vocab, batch=2, seq=40).batch_at(1)
    out, mms = {}, {}
    for remat in ("none", "full", "dots"):
        leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(params)]
        loss, _ = T.loss_fn(tree_lib.unflatten(params, leaves), cfg,
                            {k: _t(v) for k, v in batch.items()}, remat=remat)
        with Count() as c:
            out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
        mms[remat] = c.mm
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out["none"][1]))
    assert mms["dots"] == mms["none"]
    assert mms["full"] - mms["none"] == 6 * cfg.n_layers


def test_loss_fn_rejects_what_is_not_ported():
    """Every block pattern trains; an unknown one raises ValueError, as
    does an unknown remat policy."""
    unknown = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                                  block_pattern="rwkv")
    with pytest.raises(ValueError, match="unknown block pattern"):
        T.loss_fn({}, unknown, {})
    with pytest.raises(ValueError):
        T._maybe_remat(lambda x: x, "nope")


# ---------------------------------------------------------------- train step


def _jax_state(name, tcfg_kw):
    jcfg = jax_get_config(name).reduced()
    jt = jax_loop.TrainCfg(**tcfg_kw)
    return jcfg, jt, jax_loop.init_state(
        JT.init_params(jax.random.PRNGKey(0), jcfg), jt)


def _step_metrics_close(m, jm):
    for key in ("loss", "grad_norm", "lr"):
        assert _rel(m[key], jm[key]) <= RTOL, key


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    name = "tinyllama-1.1b"
    kw = dict(lr=1e-3, warmup=2, total_steps=20, microbatches=microbatches,
              remat="full")
    jcfg, jt, jstate = _jax_state(name, kw)
    cfg = get_config(name).reduced()
    state = train_state_from_jax(jstate, cfg, "cpu")
    jstep = jax.jit(jax_loop.make_train_step(jcfg, jt))
    step = loop.make_train_step(cfg, loop.TrainCfg(**kw))
    stream = synthetic.TokenStream(vocab=cfg.vocab, batch=4, seq=64, seed=0)
    allowance = None
    for i in range(3):
        batch = stream.batch_at(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        _step_metrics_close(m, jm)
        allowance = parity.adam_allowance(allowance, jstate, float(jm["lr"]))
        r = parity.compare_states(state, jstate, allowance=allowance)
        print(f"step {i}: {r}")
        assert r["flips"] == 0
        for part in ("params", "mu", "nu"):
            assert r[part] <= RTOL, (i, part, r)
        assert int(state.step) == int(jstate.step) == i + 1
        assert int(state.opt.count) == int(jstate.opt.count)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_with_compression_matches_jax(microbatches):
    """Each step from the JAX state carried across; flips counted, each
    within FLIP_MARGIN of its rounding boundary. `donate` gives the same
    state as the functional step, in the given tensors."""
    name = "qwen3-32b"
    kw = dict(lr=1e-3, warmup=2, total_steps=20, microbatches=microbatches,
              remat="dots", compress_grads=True)
    jcfg, jt, jstate = _jax_state(name, kw)
    cfg = get_config(name).reduced()
    jstep = jax.jit(jax_loop.make_train_step(jcfg, jt))
    step = loop.make_train_step(cfg, loop.TrainCfg(**kw))
    donating = loop.make_train_step(cfg, loop.TrainCfg(**kw), donate=True)
    stream = synthetic.TokenStream(vocab=cfg.vocab, batch=4, seq=48, seed=1)
    for i in range(3):
        batch = stream.batch_at(i)
        state = train_state_from_jax(jstate, cfg, "cpu")
        jstate, jm = jstep(jstate, batch)
        new, m = step(state, batch)
        _step_metrics_close(m, jm)
        r = parity.compare_states(new, jstate)
        print(f"step {i}: {r}")
        assert r["flip_margin"] <= parity.FLIP_MARGIN, r
        assert r["flips"] <= 1e-4 * sum(p.numel() for p in tree_lib.leaves(new.params))
        for part in ("params", "mu", "nu", "ef"):
            assert r[part] <= RTOL, (i, part, r)
        donated, m2 = donating(state, batch)
        assert donated.params["embed"] is state.params["embed"]
        for a, b in zip(tree_lib.leaves(donated), tree_lib.leaves(new)):
            assert torch.equal(a, b)


def test_train_state_from_jax_is_bit_identical():
    _, _, jstate = _jax_state("qwen3-32b", dict(compress_grads=True))
    jstate = jstate._replace(step=jnp.int32(5),
                             opt=jstate.opt._replace(count=jnp.int32(5)))
    state = train_state_from_jax(jstate, get_config("qwen3-32b").reduced(), "cpu")
    got, want = tree_lib.leaves(state), jax.tree_util.tree_leaves(jstate)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == {np.dtype("float32"): torch.float32,
                           np.dtype("int32"): torch.int32}[np.asarray(b).dtype]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(state.step) == 5 and state.ef is not None


# ---------------------------------------------------------------- launcher


def test_launch_train_main_trains_resumes_and_writes_jax_checkpoints(tmp_path):
    """The loss falls by the JAX test's bar (0.2 over 12 steps); a rerun
    resumes from the latest step and runs only the rest; the JAX `restore`
    reads the port's checkpoint."""
    ckpt = str(tmp_path / "ckpt")
    args = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "64",
            "--lr", "1e-3", "--microbatches", "2", "--ckpt-dir", ckpt,
            "--ckpt-every", "4", "--log-every", "4"]
    losses = launch_train.main(args + ["--steps", "12"])
    assert len(losses) == 12 and losses[-1] < losses[0] - 0.2, losses
    assert sorted(os.listdir(ckpt)) == ["step_12", "step_4", "step_8"]
    more = launch_train.main(args + ["--steps", "14"])
    assert len(more) == 2
    assert jax_ckpt.latest_step(ckpt) == 14
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    target = jax_loop.init_state(JT.init_params(jax.random.PRNGKey(0), jcfg),
                                 jax_loop.TrainCfg())
    restored = jax_ckpt.restore(ckpt, 14, target)
    assert int(restored.step) == 14 and int(restored.opt.count) == 14
    assert launch_train.main(args + ["--steps", "14"]) == []


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("name", NEW)
def test_new_configs_equal_the_jax_ones(name):
    got, want = get_config(name), jax_get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert get_config(name.replace("-", "_").replace(".", "_")) == got


@pytest.mark.parametrize("name", NEW)
def test_new_configs_prefill_and_decode_match_jax(carried, name):
    """40 prompt tokens, max_len 48: h2o-danube's reduced window (32)
    wraps its cache; then four decode steps."""
    cfg, jcfg, jparams, params = carried[name]
    tokens = np.random.RandomState(4).randint(1, cfg.vocab, (2, 40)).astype(np.int32)
    jcache, jlogits = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, 48)
    with torch.no_grad():
        cache, logits = T.prefill(params, cfg, {"tokens": _t(tokens)}, 48)
    assert _rel(logits, jlogits) <= RTOL
    tok = np.asarray(jnp.argmax(jlogits[:, :cfg.vocab], -1)).astype(np.int32)[:, None]
    for i in range(4):
        jlg, jcache = JT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
        with torch.no_grad():
            lg, cache = T.decode_step(params, cfg, cache, _t(tok))
        assert _rel(lg, jlg) <= RTOL, i
        for key in ("k", "v"):
            assert _rel(cache[key], jcache[key]) <= RTOL, (i, key)
        tok = np.asarray(jnp.argmax(jlg[:, :cfg.vocab], -1)).astype(np.int32)[:, None]
