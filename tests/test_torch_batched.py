"""The port's batched verification backend and the Quick-Probe bounds
(plain versions, on the CPU) against the JAX package on the same index and
queries.

Held: `binary_probe_lb`'s plain version against the Pallas kernel in
interpret mode, row by row, within 1e-6 relative (the two sum the bits in
other orders); `quick_probe_batch`'s representative rows and Test-A flags
equal; `_search_batch_batched` against the JAX `search_batch(...,
verification="batched")` at full budget, at a truncating budget, with the
prefilter on and with the serve engine's settings (norm-adaptive radii,
Cauchy-Schwarz pruning, k = 4): ids, rows, pages, candidates, used_round2
and exhausted equal, scores within 1e-5 relative. The module first asserts
the precondition those equalities rest on: no score within 1e-5 relative
of c_half and no two returned neighbours within 1e-5 of each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search_device as jax_sd
from repro.core.index import build_index as jax_build_index
from repro.core.quick_probe import quick_probe_batch as jax_quick_probe
from repro.core.runtime import _rescore as jax_rescore
from repro.kernels.binary_probe import binary_probe_lb as pallas_probe
from repro_torch.convert import index_from_numpy
from repro_torch.core import search_device as sd
from repro_torch.core.index import IndexArrays
from repro_torch.core.quick_probe import pack_codes, quick_probe_batch
from repro_torch.core.runtime import RuntimeConfig, search
from repro_torch.data.synthetic import mf_factors
from repro_torch.kernels import ops

K = 10
REL = 1e-5
BUILD = dict(m=8, c=0.9, p=0.6, k_p=5, k_sp=8, norm_strata=4, seed=0)
# (k, budget fraction, norm_adaptive, cs_prune, prefilter, prefilter_eps)
CASES = {
    "full budget": (K, None, False, False, False, 1.0),
    "truncating budget": (K, 0.25, False, False, False, 1.0),
    "prefilter": (K, None, False, False, True, 0.1),
    "engine settings": (4, None, True, True, False, 1.0),
}


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


def test_precondition_no_score_at_a_cut(index):
    x, q, host, meta = index["x"], index["q"], index["host"], index["meta"]
    s = q.astype(np.float64) @ x.T.astype(np.float64)
    c_half = 0.5 * meta.c * (np.float64(host["max_l2sq"])
                             + (q.astype(np.float64) ** 2).sum(1))
    assert (np.abs(s - c_half[:, None]) > REL * np.abs(c_half[:, None])).all()
    top = -np.sort(-s, axis=1)[:, : 3 * K]
    assert (-np.diff(top, axis=1) > REL * np.abs(top[:, 1:])).all()


def test_binary_probe_lb_plain_matches_pallas_row_by_row(index):
    codes = index["host"]["g_code"]                        # (G,) uint32
    rng = np.random.RandomState(0)
    q_proj = rng.standard_normal((6, index["meta"].m)).astype(np.float32)
    q_proj[0] = 0.0                                        # an all-zero row
    q_code = pack_codes(torch.from_numpy(q_proj))
    ours = ops.binary_probe_lb(torch.from_numpy(codes.astype(np.int64)),
                               q_code, torch.from_numpy(q_proj))
    assert ours.shape == (6, len(codes)) and ours.dtype == torch.float32
    for b in range(6):
        want = pallas_probe(jnp.asarray(codes),
                            jnp.asarray(np.uint32(q_code[b].item())),
                            jnp.asarray(q_proj[b]), interpret=True)
        np.testing.assert_allclose(ours[b].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0, err_msg=f"row {b}")


def test_quick_probe_batch_matches_jax(index):
    arrays, jarrays, meta = index["arrays"], index["jarrays"], index["meta"]
    rng = np.random.RandomState(1)
    q = np.concatenate([index["q"], rng.standard_normal((16, 48)).astype(np.float32)])
    qt = torch.from_numpy(q)
    q_proj = qt @ arrays.a
    rep, r0, ok = quick_probe_batch(sd._group_table(arrays), q_proj,
                                    qt.abs().sum(dim=1), meta.c, meta.x_p)
    jq = jnp.asarray(q)
    jrep, jr0, jok = jax_quick_probe(jax_sd._group_table(jarrays), jq @ jarrays.a,
                                     jnp.abs(jq).sum(axis=1), meta.c, meta.x_p)
    np.testing.assert_array_equal(rep.numpy(), np.asarray(jrep))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(r0.numpy(), np.asarray(jr0), rtol=REL)


@pytest.mark.parametrize("case", list(CASES))
def test_search_batch_batched_matches_jax(index, case):
    k, frac, norm_adaptive, cs_prune, prefilter, eps = CASES[case]
    meta, q = index["meta"], index["q"]
    budget = meta.n_blocks if frac is None else int(meta.n_blocks * frac)
    ids, scores, st = sd._search_batch_batched(
        index["arrays"], meta, torch.from_numpy(q), k, budget, budget,
        norm_adaptive, cs_prune, None, prefilter, eps)
    jids, jscores, jst = jax_sd.search_batch(
        index["jarrays"], index["jmeta"], jnp.asarray(q), k=k, budget=budget,
        budget2=budget, norm_adaptive=norm_adaptive, cs_prune=cs_prune,
        verification="batched", use_pallas=False, prefilter=prefilter,
        prefilter_eps=eps)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    for name in ("rows", "pages", "candidates", "used_round2", "exhausted",
                 "probe_passed"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    scale = np.abs(np.asarray(jscores))
    fin = np.isfinite(scale)
    np.testing.assert_array_equal(np.isfinite(scores.numpy()), fin)
    assert (np.abs(scores.numpy() - np.asarray(jscores))[fin]
            <= REL * scale[fin] + 1e-6).all()
    if frac is not None:
        assert st.exhausted.any(), "the budget truncated no query"
    if case == "engine settings":
        assert st.used_round2.any()


def test_runtime_dispatches_batched(index):
    """`runtime.search` with ``verification="batched"`` is the batched
    driver plus the exact rescore, as in the JAX runtime."""
    meta, q = index["meta"], index["q"]
    cfg = RuntimeConfig(k=4, verification="batched", norm_adaptive=True,
                        cs_prune=True)
    ids, scores, st = search(index["arrays"], meta, q, cfg, device="cpu")
    jids, _, jst = jax_sd.search_batch(
        index["jarrays"], index["jmeta"], jnp.asarray(q), k=4,
        budget=meta.n_blocks, budget2=meta.n_blocks, norm_adaptive=True,
        cs_prune=True, verification="batched", use_pallas=False)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(st.pages.numpy(), np.asarray(jst.pages))
    jscores = np.asarray(jax_rescore(index["jarrays"].x, jst.rows, jnp.asarray(q)))
    np.testing.assert_allclose(scores.numpy(), jscores, rtol=REL, atol=1e-6)
