"""The port's MoE layer (`repro_torch.models.moe`, plain torch on the CPU)
against the JAX package's `repro.models.moe`, and the in-place
`init_params` against the stacked construction it replaced.

The JAX parameters of `init_moe(PRNGKey(0), cfg)` are carried across bit
for bit; the inputs are seeded numpy. Tolerances: ``out`` within 1e-5 of
the largest |out| (relative; the expert GEMMs sum in other orders in the
two frameworks), ``aux`` within 1e-6 relative; the routing (the chosen
experts, the expert sort, which (token, slot) pairs are kept and where
each lands) equal exactly. The kept / dropped pairs of the JAX layer are
read from the lines of `apply_moe` that compute them (`_jax_route`), since
the JAX layer does not return them.

Cases: the qwen2-moe reduced config (8 experts, top-2, 1 shared) and the
moonshot reduced one (8 experts, top-2, no shared); S 1 (decode), S 16,
and a 64-token row whose router is skewed towards two experts, so that
pairs drop (capacity max(1, int(1.25 * 64 * 2 / 8)) = 20); and router
ties: zero tokens (every expert's probability equal) and two equal router
columns, where both layers keep the lower expert index.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.layers import init_mlp
from repro_torch.models.attention import init_attention

# one intra-op thread: the reduced shapes gain nothing from more, and
# beside the other test processes idle threads spin (a reduced train
# run took 25x the CPU time with the default thread count)
torch.set_num_threads(1)

MOE = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")
RTOL = 1e-5
RTOL_AUX = 1e-6


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _params(name):
    jcfg = jax_get_config(name).reduced()
    jp = jax_moe.init_moe(jax.random.PRNGKey(0), jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, copy=True)), jp)
    return get_config(name).reduced(), jcfg, jp, tp


def _jax_route(params, cfg, x, capacity_factor):
    """The routing lines of the JAX `apply_moe` (choice, order, kept pairs
    and their destinations)."""
    b, s, _ = x.shape
    e, topk = cfg.moe.n_experts, cfg.moe.top_k
    probs = jax.nn.softmax(x.astype(jnp.float32) @ params["router"], axis=-1)
    gate, choice = jax.lax.top_k(probs, topk)
    flat_expert = choice.reshape(b, s * topk)
    flat_token = jnp.broadcast_to(jnp.repeat(jnp.arange(s), topk), (b, s * topk))
    order = jnp.argsort(flat_expert, axis=1, stable=True)
    sorted_expert = jnp.take_along_axis(flat_expert, order, axis=1)
    sorted_token = jnp.take_along_axis(flat_token, order, axis=1)
    capacity = max(1, int(capacity_factor * s * topk / e))
    pos = jnp.broadcast_to(jnp.arange(s * topk), (b, s * topk))
    run_start = jax.vmap(lambda se: jnp.searchsorted(se, jnp.arange(e)))(sorted_expert)
    slot = pos - jnp.take_along_axis(run_start, sorted_expert, axis=1)
    keep = slot < capacity
    dest = jnp.where(keep, sorted_expert * capacity + slot, e * capacity)
    return dict(probs=probs, choice=choice, order=order,
                sorted_token=sorted_token, keep=keep, dest=dest)


def _compare(name, x, router=None):
    cfg, jcfg, jp, tp = _params(name)
    if router is not None:
        jp = dict(jp, router=jnp.asarray(router))
        tp = dict(tp, router=torch.from_numpy(router.copy()))
    cf = cfg.moe.capacity_factor
    jout, jaux = jax_moe.apply_moe(jp, jcfg, jnp.asarray(x), capacity_factor=cf)
    out, aux = moe.apply_moe(tp, cfg, torch.from_numpy(x), capacity_factor=cf)
    assert _rel(out, jout) <= RTOL
    assert _rel(aux, jaux) <= RTOL_AUX
    jr = _jax_route(jp, jcfg, jnp.asarray(x), cf)
    r = moe.route(tp, cfg, torch.from_numpy(x), cf)
    for key in ("choice", "order", "sorted_token", "keep", "dest"):
        np.testing.assert_array_equal(getattr(r, key).numpy(),
                                      np.asarray(jr[key]), err_msg=key)
    return r, jr


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("b,s", [(4, 1), (2, 16)])
def test_apply_moe_matches_jax(name, b, s):
    cfg = get_config(name).reduced()
    x = np.random.RandomState(s).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    r, _ = _compare(name, x)
    if s == 1:      # decode: capacity 1, a token's experts are distinct
        assert moe.capacity(cfg, 1, cfg.moe.capacity_factor) == 1
        assert bool(r.keep.all())


@pytest.mark.parametrize("name", MOE)
def test_apply_moe_with_capacity_drops_matches_jax(name):
    """A 64-token row with the router skewed so that most tokens pick
    experts 0 and 1: their runs pass the capacity and pairs drop."""
    cfg, _, jp, _ = _params(name)
    router = np.array(jp["router"], copy=True)
    router[:, 0] += 0.5
    router[:, 1] += 0.4
    x = np.abs(np.random.RandomState(5).standard_normal(
        (2, 64, cfg.d_model))).astype(np.float32)
    r, _ = _compare(name, x, router)
    cap = moe.capacity(cfg, 64, cfg.moe.capacity_factor)
    assert cap == 20
    dropped = int((~r.keep).sum())
    assert dropped > 0, "no pair dropped"
    assert int((r.run_len > cap).sum()) > 0


@pytest.mark.parametrize("name", MOE)
def test_apply_moe_router_ties_keep_the_lower_expert(name):
    """Zero tokens: every expert has probability 1/E, so the chosen experts
    are 0..topk-1 in both layers. Two equal router columns (3 and 6, made
    to lead): the tie goes to expert 3 first."""
    cfg, _, jp, _ = _params(name)
    topk = cfg.moe.top_k
    rng = np.random.RandomState(9)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    x[0, :3] = 0.0
    router = np.array(jp["router"], copy=True)
    router[:, 6] = router[:, 3] = np.abs(router[:, 3]) + 0.3
    x[1] = np.abs(x[1])
    r, jr = _compare(name, x, router)
    assert (r.choice[0, :3] == torch.arange(topk)).all()
    probs = np.asarray(jr["probs"])
    tied = probs[1, :, 3] == probs[1, :, 6]
    assert tied.all()
    lead = np.asarray(jr["choice"])[1, :, :2]
    assert (lead == [3, 6]).all(), lead
    assert (r.choice[1, :, :2] == torch.tensor([3, 6])).all()


def _stacked_reference(cfg, seed):
    """The construction `init_params` used before it filled stacked leaves
    in place: every layer's tree built, then each leaf stacked."""
    g = torch.Generator().manual_seed(seed)
    kw = dict(generator=g, device="cpu")
    from repro_torch.models.layers import dense_init
    vp, d = cfg.vocab_padded, cfg.d_model
    params = {"embed": dense_init((vp, d), scale=0.02, **kw),
              "final_norm": torch.ones((d,))}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init((d, vp), **kw)
    trees = [{"ln1": torch.ones((d,)), "ln2": torch.ones((d,)),
              "attn": init_attention(cfg, **kw),
              "mlp": init_mlp(d, cfg.d_ff, **kw)} for _ in range(cfg.n_layers)]

    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        return torch.stack(ts)

    params["blocks"] = stack(trees)
    return params


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen3-32b"])
def test_init_params_in_place_equals_the_stacked_construction(name):
    """Dense configs draw the same weights bit for bit as before the
    in-place fill (qwen3: q/k norms and an untied unembed)."""
    cfg = get_config(name).reduced()
    want = _stacked_reference(cfg, 3)
    got = T.init_params(cfg, seed=3, device="cpu")
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, a), (_, b) in zip(wl, gl):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b",
                                  "internvl2-2b", "whisper-base"])
def test_init_params_shapes_match_jax(name):
    """Every leaf of the port's tree has the JAX tree's path, shape and
    dtype (the router is f32 in both)."""
    cfg = get_config(name).reduced()
    jp = jax.eval_shape(lambda: __import__(
        "repro.models.transformer", fromlist=["x"]).init_params(
            jax.random.PRNGKey(0), jax_get_config(name).reduced()))
    tp = T.init_params(cfg, seed=0, device="cpu")
    jl = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
          for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    tl = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype).replace(
        "torch.", "")) for p, a in jax.tree_util.tree_leaves_with_path(tp)}
    assert tl == jl
