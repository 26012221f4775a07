"""The port's facade backends against the JAX package's `api.build`, and
`ops.mips_topk` against the JAX `ops.mips_topk`, on the CPU.

Held: `api.build` for ``promips`` (device search on the CPU in two-phase,
scan and progressive mode, and ``search_path="host"`` in both modes),
``exact``, ``h2alsh``, ``pq`` and ``rangelsh``, on the same rows and seed
(n = 3,000, d = 32): equal ids, stats dicts and index bytes; scores equal
bit for bit on the host engines and within 1e-5 relative (+1e-6) on the
device search (both packages rescore the winners with their own einsum).
`PromipsSearcher.state()` carried across with `convert.promips_from_state`
and through the port's own `from_state`: equal arrays and the same
results. `backends()` lists every JAX backend, and ``sharded`` builds.
`ops.mips_topk`: its block_mips route (k <=
128) against the Pallas route in interpret mode on tie-free data (equal
rows, scores within 1e-5 relative, -1 / -inf past the valid rows), and
against the oracle route (mips_score + top-k) at k <= 128 and k > 128.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.kernels import ops as jax_ops
from repro_torch import api
from repro_torch.api.adapters import PromipsSearcher
from repro_torch.convert import promips_from_state
from repro_torch.data.synthetic import mf_factors
from repro_torch.kernels import ops

# one intra-op thread: the reduced shapes gain nothing from more, and
# beside the other test processes idle threads spin (a reduced train
# run took 25x the CPU time with the default thread count)
torch.set_num_threads(1)

REL = 1e-5
CASES = {
    "promips": ("promips", {"m": 8}),
    "promips-scan": ("promips", {"m": 8, "verification": "scan"}),
    "promips-progressive": ("promips", {"m": 8, "mode": "progressive"}),
    "promips-host": ("promips", {"m": 8, "search_path": "host"}),
    "promips-host-progressive": ("promips", {"m": 8, "search_path": "host",
                                             "mode": "progressive"}),
    "exact": ("exact", {}),
    "h2alsh": ("h2alsh", {}),
    "pq": ("pq", {}),
    "rangelsh": ("rangelsh", {}),
}


@pytest.fixture(scope="module")
def data():
    x = mf_factors(3000, 32, 8, decay=0.5, norm_tail=0.6, seed=0)
    q = mf_factors(12, 32, 8, decay=0.5, seed=1)
    return x, q


@pytest.fixture
def jax_clean(monkeypatch):
    """`jax.core.trace_state_clean`, which the JAX `runtime.search` asks for
    and this jax lacks, set for one test."""
    monkeypatch.setattr(jax.core, "trace_state_clean", lambda: True,
                        raising=False)


def _stats(res):
    return {k: v for k, v in res.stats.items() if k != "wall_time_s"}


@pytest.mark.parametrize("case", list(CASES))
def test_build_matches_jax(data, jax_clean, case):
    backend, opts = CASES[case]
    x, q = data
    guarantee = api.GuaranteeConfig(c=0.9, p0=0.6, k=10)
    jguarantee = jax_api.GuaranteeConfig(c=0.9, p0=0.6, k=10)
    ours = api.build(x, backend=backend, guarantee=guarantee, seed=3,
                     page_bytes=4096, device="cpu", **opts)
    ref = jax_api.build(x, backend=backend, guarantee=jguarantee, seed=3,
                        page_bytes=4096, **opts)
    got, want = ours.search(q), ref.search(q)
    np.testing.assert_array_equal(got.ids, want.ids)
    assert _stats(got) == _stats(want)
    assert ours.index_bytes == ref.index_bytes and ours.n == ref.n
    host = backend != "promips" or opts.get("search_path") == "host"
    if host:
        np.testing.assert_array_equal(got.scores, want.scores)
    else:
        fin = np.isfinite(want.scores)
        np.testing.assert_array_equal(np.isfinite(got.scores), fin)
        assert (np.abs(got.scores[fin] - want.scores[fin])
                <= REL * np.abs(want.scores[fin]) + 1e-6).all()
    # a single query and k other than the guarantee's
    one, jone = ours.search(q[0], k=3), ref.search(q[0], k=3)
    np.testing.assert_array_equal(one.ids, jone.ids)


def test_backends_list_all_but_sharded():
    """Every JAX backend is registered, ``sharded`` too: it builds and
    searches (its parity is `tests/test_torch_sharded.py`'s)."""
    assert api.backends() == jax_api.backends()
    s = api.build(mf_factors(100, 8, 4, seed=0), backend="sharded",
                  device="cpu", m=4, n_shards=2)
    assert isinstance(s, api.ShardedSearcher) and s.n == 100
    assert s.search(mf_factors(2, 8, 4, seed=1), k=3).ids.shape == (2, 3)


def test_promips_state_round_trips(data, jax_clean):
    x, q = data
    ref = jax_api.build(x, backend="promips", seed=1, page_bytes=4096, m=8,
                        mode="progressive")
    arrays, meta = ref.state()
    carried = promips_from_state(arrays, meta, device="cpu")
    want = ref.search(q)
    got = carried.search(q)
    np.testing.assert_array_equal(got.ids, want.ids)
    assert _stats(got) == _stats(want)
    assert carried.runtime.mode == "progressive" and carried.runtime.cs_prune
    # the port's own state, back through from_state: the same arrays
    ours_arrays, ours_meta = carried.state()
    for name, arr in arrays.items():
        np.testing.assert_array_equal(ours_arrays[name], np.asarray(arr))
    assert ours_meta["meta"] == meta["meta"]
    again = PromipsSearcher.from_state(ours_arrays, ours_meta, device="cpu")
    np.testing.assert_array_equal(again.search(q).ids, got.ids)
    host = PromipsSearcher.from_state(
        ours_arrays, dict(ours_meta, search_path="host"), device="cpu")
    np.testing.assert_array_equal(host.search(q).ids,
                                  ref.__class__.from_state(
                                      arrays, dict(meta, search_path="host")
                                  ).search(q).ids)


def _mips_inputs(r, b, d, k, invalid, seed):
    """Gaussian rows and queries; tie-free where it decides the result: no
    two of a query's k + 1 best valid scores within 1e-5 relative."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((r, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = rng.rand(r) >= invalid
    s = -np.sort(-(q.astype(np.float64) @ x[valid].T.astype(np.float64)),
                 axis=1)[:, :k + 1]
    assert (-np.diff(s, axis=1) > REL * np.abs(s[:, 1:])).all()
    return x, q, valid


@pytest.mark.parametrize("r,b,d,k,invalid", [
    (1000, 5, 32, 1, 0.0), (1000, 5, 32, 10, 0.1), (777, 3, 48, 128, 0.05),
    (50, 2, 16, 60, 0.2)])                         # fewer valid rows than k
def test_mips_topk_matches_pallas_route(r, b, d, k, invalid):
    x, q, valid = _mips_inputs(r, b, d, k, invalid, seed=r + k)
    top, rows = ops.mips_topk(torch.from_numpy(x), torch.from_numpy(q),
                              torch.from_numpy(valid), k)
    jtop, jrows = jax_ops.mips_topk(jnp.asarray(x), jnp.asarray(q),
                                    jnp.asarray(valid), k, use_pallas=True)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    jtop = np.asarray(jtop)
    fin = np.isfinite(jtop)
    np.testing.assert_array_equal(np.isfinite(top.numpy()), fin)
    np.testing.assert_allclose(top.numpy()[fin], jtop[fin], rtol=REL, atol=1e-6)
    if k > valid.sum():
        assert (rows.numpy()[:, valid.sum():] == -1).all()


@pytest.mark.parametrize("r,b,d,k,invalid", [
    (1000, 5, 32, 10, 0.1), (600, 4, 32, 128, 0.0), (600, 4, 32, 129, 0.1),
    (300, 3, 16, 290, 0.1)])                       # -1e30 rows in the top-k
def test_mips_topk_matches_oracle_route(r, b, d, k, invalid):
    x, q, valid = _mips_inputs(r, b, d, k, invalid, seed=r + 2 * k)
    top, rows = ops.mips_topk(torch.from_numpy(x), torch.from_numpy(q),
                              torch.from_numpy(valid), k)
    jtop, jrows = jax_ops.mips_topk(jnp.asarray(x), jnp.asarray(q),
                                    jnp.asarray(valid), k, use_pallas=False)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_allclose(top.numpy(), np.asarray(jtop), rtol=REL,
                               atol=1e-6)
