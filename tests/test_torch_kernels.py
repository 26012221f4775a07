"""The port's kernel entries (their plain PyTorch versions, as they run on
the CPU) against the JAX package: the Pallas kernels in interpret mode and
the jnp oracles of `repro.kernels.ref`.

Held: rows, cnt, pages and candidates equal; scores within 1e-5 relative
to the dot product's scale ||q|| ||x||. The two frameworks sum GEMMs in
other orders, so float cases first assert their precondition: no valid
score within 1e-5 relative of c_half or of a neighbouring top-k score.
Ties are held exactly on integer-valued data, where every product is exact
in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.mips_topk import mips_score as jax_mips_score_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref

REL = 1e-5
# one compile per shape instead of one per eager op
_jax_block_mips_ref = jax.jit(jax_ref.block_mips_ref,
                              static_argnames=("k", "page_rows", "dense"))
_jax_block_mips_cached = jax.jit(jax_ops.block_mips_cached,
                                 static_argnames=("k", "page_rows"))


def _round(seed, nb, p, d, b, k, ns, dense, integer, valid_frac=0.85):
    """Seeded round inputs: padding slots (sparse), invalid rows, duplicate
    rows, a carried top-k holding hits and empty (-inf, -1) tails."""
    rng = np.random.RandomState(seed)
    n = nb * p
    if integer:
        x = rng.randint(-3, 4, (n, d)).astype(np.float32)
        q = rng.randint(-3, 4, (b, d)).astype(np.float32)
        dup = rng.choice(n, n // 6, replace=False)
        x[dup] = x[rng.choice(n, len(dup))]                  # exact ties
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((b, d)).astype(np.float32)
    valid = rng.rand(n) < valid_frac
    if dense:
        slots = np.arange(nb, dtype=np.int32)
        sel = rng.rand(b, nb) > 0.3
    else:
        blocks = np.sort(rng.choice(nb, ns - 2, replace=False))
        slots = np.concatenate([blocks, [0, 0]]).astype(np.int32)
        sel = rng.rand(b, ns) > 0.4
        sel[:, ns - 2:] = False                              # padding slots
    s = q.astype(np.float64) @ x.T.astype(np.float64)
    c_half = np.quantile(s, 0.95, axis=1).astype(np.float32)
    if integer:
        c_half += 0.5
    lo, hi = np.quantile(s, 0.5), s.max()
    init = rng.randint(int(lo), int(hi) + 1, (b, k)) if integer else \
        rng.uniform(lo, hi, (b, k))
    init_s = np.sort(init.astype(np.float32), axis=1)[:, ::-1].copy()
    init_r = rng.randint(0, n, (b, k)).astype(np.int32)
    tail = rng.randint(0, k + 1, b)
    for i in range(b):
        init_s[i, k - tail[i]:] = -np.inf
        init_r[i, k - tail[i]:] = -1
    return x, valid, q, slots, sel, init_s, init_r, c_half


def _assert_precondition(x, valid, q, slots, sel, init_s, c_half, k, p):
    """No valid selected score within 1e-5 relative of c_half, and the top
    k + 1 candidate scores (carried and tile) pairwise apart by 1e-5."""
    rows = (slots[:, None] * p + np.arange(p)).reshape(-1)
    s = q.astype(np.float64) @ x[rows].T.astype(np.float64)          # (B, R)
    ok = valid[rows][None, :] & np.repeat(sel, p, axis=1)
    ch = c_half[:, None].astype(np.float64)
    near = np.abs(s - ch) <= REL * np.abs(ch)
    assert not (near & ok).any(), "precondition: a score lies at c_half"
    for i in range(q.shape[0]):
        cand = np.sort(np.concatenate([s[i][ok[i]], init_s[i][np.isfinite(init_s[i])]]))
        top = cand[::-1][: k + 1]
        gap = -np.diff(top)
        assert (gap > REL * np.abs(top[1:])).all(), \
            "precondition: two top-k scores within 1e-5 relative"


GRID = [  # (seed, nb, p, d, b, k, ns, dense)
    (0, 12, 8, 32, 1, 1, 8, False),
    (1, 20, 21, 48, 5, 10, 12, False),
    (2, 16, 32, 32, 16, 32, 10, False),
    (3, 24, 21, 48, 16, 1, 24, True),
    (5, 12, 8, 32, 5, 32, 12, True),
    (6, 10, 21, 48, 1, 10, 10, True),
]


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer-ties"])
@pytest.mark.parametrize("case", GRID, ids=[f"B{c[4]}-k{c[5]}-{'dense' if c[7] else 'sparse'}"
                                            for c in GRID])
def test_block_mips_plain_matches_jax_oracle(case, integer):
    seed, nb, p, d, b, k, ns, dense = case
    args = _round(seed, nb, p, d, b, k, ns, dense, integer)
    x, valid, q, slots, sel, init_s, init_r, c_half = args
    if not integer:
        _assert_precondition(x, valid, q, slots, sel, init_s, c_half, k, p)
    got = ops.block_mips(*[torch.from_numpy(a) for a in args], k=k, page_rows=p,
                         dense=dense)
    want = _jax_block_mips_ref(*[jnp.asarray(a) for a in args], k=k,
                               page_rows=p, dense=dense)
    _assert_round_equal(got, want, args)


@pytest.mark.parametrize("case", [GRID[1], GRID[4]], ids=["sparse", "dense"])
def test_block_mips_plain_matches_pallas_interpret(case):
    """Float data only: the Pallas kernel's rank-select breaks exact ties
    toward the higher index, unlike `ref.block_mips_ref` and `lax.top_k`,
    whose rule the port follows (ROADMAP, Queue 3)."""
    seed, nb, p, d, b, k, ns, dense = case
    args = _round(seed + 10, nb, p, d, b, k, ns, dense, integer=False)
    x, valid, q, slots, sel, init_s, init_r, c_half = args
    _assert_precondition(x, valid, q, slots, sel, init_s, c_half, k, p)
    got = ops.block_mips(*[torch.from_numpy(a) for a in args], k=k, page_rows=p,
                         dense=dense)
    want = jax_ops.block_mips(*[jnp.asarray(a) for a in args], k=k, page_rows=p,
                              use_pallas=True)
    _assert_round_equal(got, want, args)


@pytest.mark.parametrize("k", [1025, 4096])
def test_block_mips_plain_large_k_matches_jax_oracle(k):
    """The streaming over-fetch's k (above the CUDA kernel's shared-memory
    merge), on integer data with ties: equal rows, counts and scores."""
    nb, p = 300, 8 if k < 4096 else 16
    args = _round(11 + k, nb, p, 32, 4, k, 200, k >= 4096, integer=True)
    got = ops.block_mips(*[torch.from_numpy(a) for a in args], k=k, page_rows=p,
                         dense=k >= 4096)
    want = _jax_block_mips_ref(*[jnp.asarray(a) for a in args], k=k,
                               page_rows=p, dense=k >= 4096)
    _assert_round_equal(got, want, args)
    assert int(got[4].max()) > 0


def test_block_mips_fewer_valid_rows_than_k():
    """Two slots of 8 rows, most invalid, k = 32: the tail is (-inf, -1)."""
    args = _round(7, 6, 8, 32, 3, 32, 4, False, integer=False, valid_frac=0.4)
    args[5][:] = -np.inf
    args[6][:] = -1
    got = ops.block_mips(*[torch.from_numpy(a) for a in args], k=32, page_rows=8)
    want = _jax_block_mips_ref(*[jnp.asarray(a) for a in args], k=32,
                               page_rows=8)
    _assert_round_equal(got, want, args)
    assert (got[1] == -1).any() and torch.isinf(got[0][got[1] == -1]).all()


def _assert_round_equal(got, want, args):
    x, q = args[0], args[2]
    scale = np.linalg.norm(q, axis=1).max() * np.linalg.norm(x, axis=1).max()
    top_s, *rest = got
    np.testing.assert_allclose(top_s.numpy(), np.asarray(want[0]), rtol=REL,
                               atol=REL * scale)
    for name, g, w in zip(("top_r", "cnt", "pages", "cand"), rest, want[1:]):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_block_mips_cached_matches_jax():
    seed, nb, p, d, b, k, ns, dense = GRID[1]
    round_args = _round(seed, nb, p, d, b, k, ns, False, integer=True)
    x, valid, q, slots, sel, init_s, init_r, c_half = round_args
    scores_full = (q @ x.T).astype(np.float32)
    args = (scores_full, valid, slots, sel, init_s, init_r, c_half)
    got = ops.block_mips_cached(*[torch.from_numpy(a) for a in args], k=k,
                                page_rows=p)
    want = _jax_block_mips_cached(*[jnp.asarray(a) for a in args], k=k,
                                  page_rows=p)
    _assert_round_equal(got, want, round_args)


@pytest.fixture(scope="module")
def sketch_inputs():
    rng = np.random.RandomState(3)
    b, m, kcw, sub_d, nb = 9, 16, 64, 3, 700
    q = rng.standard_normal((b, m * sub_d)).astype(np.float32)
    codebooks = rng.standard_normal((m, kcw, sub_d)).astype(np.float32)
    codes = rng.randint(0, kcw, (nb, m)).astype(np.int32)
    sk_mu = np.concatenate([codebooks[s][codes[:, s]] for s in range(m)], axis=1)
    scale = (np.linalg.norm(q, axis=1)[:, None]
             * np.linalg.norm(sk_mu, axis=1)[None, :])
    return q, sk_mu, codebooks, codes, scale


def test_sketch_scores_plain_matches_jax_oracle(sketch_inputs):
    """GEMM against GEMM: |d| <= 1e-6 |q||mu| + 1e-7."""
    q, sk_mu, codebooks, codes, scale = sketch_inputs
    got = ops.sketch_scores(*[torch.from_numpy(a) for a in (q, sk_mu, codebooks, codes)])
    want = np.asarray(jax_ref.sketch_scores_ref(jnp.asarray(q), jnp.asarray(sk_mu)))
    assert (np.abs(got.numpy() - want) <= 1e-6 * scale + 1e-7).all()


def test_sketch_scores_plain_matches_pallas_interpret(sketch_inputs):
    """GEMM against the LUT kernel's sum order: the stated tolerance
    |d| <= 1e-5 |q||mu| + 1e-6."""
    q, sk_mu, codebooks, codes, scale = sketch_inputs
    got = ops.sketch_scores(*[torch.from_numpy(a) for a in (q, sk_mu, codebooks, codes)])
    want = np.asarray(jax_ops.sketch_scores(
        jnp.asarray(q), jnp.asarray(sk_mu), jnp.asarray(codebooks),
        jnp.asarray(codes), use_pallas=True))
    assert (np.abs(got.numpy() - want) <= 1e-5 * scale + 1e-6).all()


# (B, NB, M, K, d/M): ragged NB, B not a multiple of 8, M 8 and 16
LUT_CASES = [(9, 700, 16, 64, 3), (13, 777, 8, 32, 4), (64, 1001, 16, 256, 8),
             (5, 129, 8, 191, 2), (1, 513, 16, 16, 1)]


def _lut_inputs(b, nb, m, kcw, sub_d):
    rng = np.random.RandomState(b * 31 + nb + m)
    q = rng.standard_normal((b, m * sub_d)).astype(np.float32)
    codebooks = rng.standard_normal((m, kcw, sub_d)).astype(np.float32)
    codes = rng.randint(0, kcw, (nb, m)).astype(np.int32)
    sk_mu = np.concatenate([codebooks[s][codes[:, s]] for s in range(m)], axis=1)
    scale = (np.linalg.norm(q, axis=1)[:, None]
             * np.linalg.norm(sk_mu, axis=1)[None, :])
    return q, sk_mu, codebooks, codes, scale


@pytest.mark.parametrize("b,nb,m,kcw,sub_d", LUT_CASES,
                         ids=[f"B{c[0]}-NB{c[1]}-M{c[2]}" for c in LUT_CASES])
def test_sketch_scores_lut_ref_matches_pallas_and_gemm(b, nb, m, kcw, sub_d):
    """The ordered LUT sum (the CUDA kernel's arithmetic) against the JAX
    LUT kernel in interpret mode and against the GEMM plain version: the
    stated |d| <= 1e-5 |q||mu| + 1e-6 (other sum orders, and the two
    frameworks' einsums may round the table differently)."""
    q, sk_mu, codebooks, codes, scale = _lut_inputs(b, nb, m, kcw, sub_d)
    got = ref.sketch_scores_lut_ref(torch.from_numpy(q),
                                    torch.from_numpy(codebooks),
                                    torch.from_numpy(codes))
    assert got.shape == (b, nb) and got.dtype == torch.float32
    pallas = np.asarray(jax_ops.sketch_scores(
        jnp.asarray(q), jnp.asarray(sk_mu), jnp.asarray(codebooks),
        jnp.asarray(codes), use_pallas=True))
    gemm = ref.sketch_scores_ref(torch.from_numpy(q), torch.from_numpy(sk_mu))
    for want in (pallas, gemm.numpy()):
        assert (np.abs(got.numpy() - want) <= 1e-5 * scale + 1e-6).all()


def test_sketch_scores_lut_ref_is_the_ordered_table_sum():
    """Bit for bit: est[b, n] = (((0 + t_0) + t_1) + ...) + t_{M-1} in f32
    over t_s = lut[b, s, codes[n, s]], the table from `ref.sketch_lut`."""
    q, _, codebooks, codes, _ = _lut_inputs(7, 300, 8, 64, 4)
    lut = ref.sketch_lut(torch.from_numpy(q), torch.from_numpy(codebooks)).numpy()
    want = np.zeros((7, 300), np.float32)
    for s in range(8):
        want = want + lut[:, s, codes[:, s]]
    got = ref.sketch_scores_lut_ref(torch.from_numpy(q),
                                    torch.from_numpy(codebooks),
                                    torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)


MIPS_SHAPES = [(1, 1, 1), (37, 5, 19), (300, 9, 128), (513, 130, 200)]


@pytest.mark.parametrize("r,b,d", MIPS_SHAPES,
                         ids=[f"R{r}-B{b}-d{d}" for r, b, d in MIPS_SHAPES])
def test_mips_score_plain_matches_jax(r, b, d):
    """The plain `mips_score` against the JAX Pallas kernel in interpret
    mode and the JAX oracle at ragged R, B and d: within 1e-5 relative to
    |q||x| on float data, and invalid rows exactly -1e30 (not -inf)."""
    rng = np.random.RandomState(r * 7 + b + d)
    x = rng.standard_normal((r, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = rng.rand(r) > 0.3
    valid[0] = False
    got = ops.mips_score(torch.from_numpy(x), torch.from_numpy(q),
                         torch.from_numpy(valid))
    assert got.shape == (r, b) and got.dtype == torch.float32
    assert bool((got[torch.from_numpy(~valid)] == ref.MASKED).all())
    scale = (np.linalg.norm(x, axis=1)[:, None]
             * np.linalg.norm(q, axis=1)[None, :])
    for want in (jax_mips_score_pallas(jnp.asarray(x), jnp.asarray(q),
                                       jnp.asarray(valid), interpret=True),
                 jax_ref.mips_score_ref(jnp.asarray(x), jnp.asarray(q),
                                        jnp.asarray(valid))):
        want = np.asarray(want)
        np.testing.assert_array_equal(want[~valid], got.numpy()[~valid])
        assert (np.abs(got.numpy() - want) <= REL * scale + 1e-6).all()


def test_mips_score_plain_integer_data_is_exact():
    rng = np.random.RandomState(1)
    x = rng.randint(-3, 4, (70, 33)).astype(np.float32)
    q = rng.randint(-3, 4, (6, 33)).astype(np.float32)
    valid = rng.rand(70) > 0.2
    got = ops.mips_score(torch.from_numpy(x), torch.from_numpy(q),
                         torch.from_numpy(valid))
    want = jax_ops.mips_score(jnp.asarray(x), jnp.asarray(q),
                              jnp.asarray(valid), use_pallas=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
