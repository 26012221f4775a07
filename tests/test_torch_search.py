"""The port's two-phase fused search (plain versions, on the CPU) against
the JAX package's `search_fused.search_batch_fused` + `runtime._rescore`
on the same index and queries.

Held: ids, rows, pages, candidates, probe_passed, used_round2, exhausted
and every (B, NB) mask equal; radii and scores within 1e-5 relative (to
the dot product's scale for scores). Sums run in other orders in the two
frameworks, so the module first asserts its precondition: no valid score
within 1e-5 relative of c_half, no two returned neighbours within 1e-5 of
each other, and no prefilter bound within 1e-5 of its cut.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search_device as jax_sd
from repro.core.index import build_index as jax_build_index
from repro.core.runtime import _rescore as jax_rescore
from repro.core.search_fused import search_batch_fused as jax_search_fused
from repro_torch.convert import index_from_numpy
from repro_torch.core import search_device as sd
from repro_torch.core.index import IndexArrays
from repro_torch.core.runtime import _rescore
from repro_torch.core.search_fused import search_batch_fused
from repro_torch.data.synthetic import mf_factors

# one intra-op thread: the reduced shapes gain nothing from more, and
# beside the other test processes idle threads spin (a reduced train
# run took 25x the CPU time with the default thread count)
torch.set_num_threads(1)

K = 10
REL = 1e-5
BUILD = dict(m=8, c=0.9, p=0.6, k_p=5, k_sp=8, norm_strata=4, seed=0)
# one compile per call site instead of one per eager op
_jax_frontend = jax.jit(jax_sd.select_frontend, static_argnames=("meta",))
_jax_compensation = jax.jit(jax_sd.compensation_masks,
                            static_argnames=("meta", "norm_adaptive", "cs_prune"))
_jax_prefilter1 = jax.jit(jax_sd.prefilter_round1,
                          static_argnames=("k", "page_rows", "eps", "use_pallas"))


@pytest.fixture(scope="module")
def index():
    x = mf_factors(4000, 48, 12, decay=0.5, norm_tail=0.6, seed=0)
    q = mf_factors(16, 48, 12, decay=0.5, seed=1)
    ref = jax_build_index(x, **BUILD)
    host = {f: np.asarray(getattr(ref.arrays, f)) for f in IndexArrays._fields}
    arrays, meta = index_from_numpy(host, dataclasses.asdict(ref.meta),
                                    device="cpu")
    jarrays = jax.tree.map(jnp.asarray, ref.arrays)
    return dict(x=x, q=q, host=host, meta=meta, jmeta=ref.meta,
                arrays=arrays, jarrays=jarrays)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _frontends(index):
    q = index["q"]
    ours = sd.select_frontend(index["arrays"], index["meta"], torch.from_numpy(q))
    ref = _jax_frontend(index["jarrays"], index["jmeta"], jnp.asarray(q))
    return ours, ref


def test_precondition_no_score_or_bound_at_a_cut(index):
    """Margins the parity below relies on, in float64."""
    x, q, host, meta = index["x"], index["q"], index["host"], index["meta"]
    s = q.astype(np.float64) @ x.T.astype(np.float64)                 # (B, n)
    c_half = 0.5 * meta.c * (np.float64(host["max_l2sq"])
                             + (q.astype(np.float64) ** 2).sum(1))
    assert (np.abs(s - c_half[:, None]) > REL * np.abs(c_half[:, None])).all()
    top = -np.sort(-s, axis=1)[:, : 3 * K]
    assert (-np.diff(top, axis=1) > REL * np.abs(top[:, 1:])).all()
    est = q.astype(np.float64) @ host["sk_mu"].T.astype(np.float64)
    scale = (np.linalg.norm(q, axis=1)[:, None]
             * np.linalg.norm(host["sk_mu"], axis=1)[None, :])
    (_, _, _, _, _, _, mask0), _ = _frontends(index)
    for eps in (0.3, 0.1):
        bnd = eps * np.linalg.norm(q.astype(np.float64), axis=1)[:, None] \
            * host["sk_err"][None, :]
        lb = np.where(mask0.numpy(), est - bnd, -np.inf)
        nb, g = lb.shape[1], 2 * K
        lb = np.concatenate([lb, np.full((lb.shape[0], (-nb) % g), -np.inf)], 1)
        tau = np.sort(lb.reshape(lb.shape[0], -1, g).max(1), axis=1)[:, g - K]
        margin = np.abs(est + bnd - tau[:, None])[mask0.numpy()]
        assert (margin > REL * scale[mask0.numpy()]).all(), eps


def test_select_frontend_matches_jax(index):
    ours, ref = _frontends(index)
    names = ("q_proj", "q_l2sq", "d_sp", "r0", "probe_ok", "c_half", "mask0")
    for name, a, b in zip(names, ours, ref):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, name
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=REL, atol=REL * np.abs(b).max(),
                                       err_msg=name)


@pytest.mark.parametrize("norm_adaptive,cs_prune", [(False, False), (True, True)])
def test_compensation_masks_match_jax(index, norm_adaptive, cs_prune):
    (_, q_l2sq, d_sp, r0, _, c_half, mask0), _ = _frontends(index)
    rng = np.random.RandomState(0)
    s_k = (c_half.numpy() * rng.uniform(0.2, 1.2, c_half.shape[0])).astype(np.float32)
    s_k[::5] = -np.inf                                   # empty top-k
    done_a = rng.rand(c_half.shape[0]) < 0.3
    inputs = (d_sp.numpy(), q_l2sq.numpy(), s_k, r0.numpy(), done_a, mask0.numpy())
    ours = sd.compensation_masks(index["arrays"], index["meta"],
                                 *[torch.from_numpy(a) for a in inputs],
                                 norm_adaptive, cs_prune)
    ref = _jax_compensation(index["jarrays"], index["jmeta"],
                            *[jnp.asarray(a) for a in inputs],
                            norm_adaptive, cs_prune)
    np.testing.assert_array_equal(_np(ours[0]), _np(ref[0]), err_msg="need2")
    np.testing.assert_allclose(_np(ours[1]), _np(ref[1]), rtol=REL, err_msg="r1")
    np.testing.assert_array_equal(_np(ours[2]), _np(ref[2]), err_msg="mask1")
    assert _np(ours[2]).any()


def test_prefilter_rounds_match_jax(index):
    (_, _, _, _, _, c_half, mask0), _ = _frontends(index)
    q = index["q"]
    ours = sd.prefilter_round1(index["arrays"], torch.from_numpy(q), mask0, K,
                               index["meta"].page_rows, 0.1)
    ref = _jax_prefilter1(index["jarrays"], jnp.asarray(q),
                          jnp.asarray(mask0.numpy()), K,
                          index["meta"].page_rows, 0.1, False)
    for name, a, b in zip(("surv", "est", "bnd", "bvalid"), ours, ref):
        a, b = _np(a), _np(b)
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=REL, atol=REL * np.abs(b).max(),
                                       err_msg=name)
    assert 0 < _np(ours[0]).sum() < mask0.numpy().sum()      # the cut bites
    s_k = (c_half.numpy() * 0.6).astype(np.float32)
    mask1 = ~mask0.numpy()
    r2 = sd.prefilter_round2(torch.from_numpy(mask1), *ours[1:],
                             torch.from_numpy(s_k))
    r2_ref = jax_sd.prefilter_round2(jnp.asarray(mask1), *ref[1:], jnp.asarray(s_k))
    np.testing.assert_array_equal(_np(r2), _np(r2_ref))


def test_topk_merge_matches_jax_with_ties():
    """Batched merge against the JAX per-query merge: ties go to the carried
    entries first, then new rows in order."""
    from repro.core import search_common as jax_sc
    from repro_torch.core import search_common as sc
    rng = np.random.RandomState(0)
    top_s = -np.sort(-rng.randint(0, 6, (4, K)).astype(np.float32), axis=1)
    top_r = rng.randint(0, 100, (4, K)).astype(np.int32)
    new_s = rng.randint(0, 6, (4, 7)).astype(np.float32)
    new_r = rng.randint(100, 200, (4, 7)).astype(np.int32)
    s, r = sc.topk_merge(*[torch.from_numpy(a) for a in (top_s, top_r, new_s, new_r)], K)
    for i in range(4):
        js, jr = jax_sc.topk_merge(jnp.asarray(top_s[i]), jnp.asarray(top_r[i]),
                                   jnp.asarray(new_s[i]), jnp.asarray(new_r[i]), K)
        np.testing.assert_array_equal(s[i].numpy(), np.asarray(js))
        np.testing.assert_array_equal(r[i].numpy(), np.asarray(jr))


SETTINGS = {
    "full-budget": dict(),
    "full-budget-prefilter-0.3": dict(prefilter=True, prefilter_eps=0.3),
    "half-budget-prefilter-0.3": dict(budget=0.5, prefilter=True,
                                      prefilter_eps=0.3),
    "quarter-budget": dict(budget=0.25),
    "dense-0.05-prefilter-0.1": dict(prefilter=True, prefilter_eps=0.1,
                                     dense_frac=0.05),
    "sparse-1.0-half-budget": dict(budget=0.5, dense_frac=1.0),
    "norm-adaptive-cs-prune": dict(norm_adaptive=True, cs_prune=True,
                                   prefilter=True, prefilter_eps=0.3),
}


def _search_both(index, setting, use_pallas=False):
    nb = index["meta"].n_blocks
    kw = dict(setting)
    budget = int(nb * kw.pop("budget", 1.0))
    kw.update(k=K, budget=budget, budget2=budget)
    q = index["q"]
    ids, _, st = search_batch_fused(index["arrays"], index["meta"],
                                    torch.from_numpy(q), **kw)
    scores = _rescore(index["arrays"].x, st.rows, torch.from_numpy(q))
    jq = jnp.asarray(q)
    jids, _, jst = jax_search_fused(index["jarrays"], index["jmeta"], jq,
                                    use_pallas=use_pallas, **kw)
    jscores = jax_rescore(index["jarrays"].x, jst.rows, jq)
    return (ids, scores, st), (jids, jscores, jst)


def _assert_search_equal(index, ours, ref):
    (ids, scores, st), (jids, jscores, jst) = ours, ref
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids), err_msg="ids")
    for name in ("rows", "pages", "candidates", "probe_passed", "used_round2",
                 "exhausted"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    for name in ("radius0", "radius1"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)), rtol=REL,
                                   err_msg=name)
    q, x = index["q"], index["x"]
    scale = np.linalg.norm(q, axis=1).max() * np.linalg.norm(x, axis=1).max()
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=REL,
                               atol=REL * scale, err_msg="scores")
    returned = np.sort(scores.numpy(), axis=1)[:, ::-1].astype(np.float64)
    finite = np.isfinite(returned[:, 1:])
    gap = returned[:, :-1] - returned[:, 1:]
    assert (gap[finite] > REL * np.abs(returned[:, 1:][finite])).all(), \
        "precondition: two returned neighbours within 1e-5 relative"


@pytest.mark.parametrize("name", list(SETTINGS))
def test_search_fused_matches_jax(index, name):
    ours, ref = _search_both(index, SETTINGS[name])
    _assert_search_equal(index, ours, ref)
    st = ours[2]
    if "budget" in SETTINGS[name]:
        assert bool(st.exhausted.any())               # truncation acted


def test_search_fused_matches_jax_pallas_interpret(index):
    """The JAX side on its Pallas kernels (interpret mode) at the main
    path's knobs: its LUT sketch sums in another order than the port's CPU
    GEMM, within the prefilter margins the precondition asserts."""
    setting = dict(prefilter=True, prefilter_eps=0.1, dense_frac=0.8)
    ours, ref = _search_both(index, setting, use_pallas=True)
    _assert_search_equal(index, ours, ref)
