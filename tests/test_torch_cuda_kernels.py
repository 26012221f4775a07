"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (the decision is made
inside the fixture). Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py

`block_mips` and `mips_score` are held on integer-valued data, where every
dot product is exact in f32 whatever the summation order, so kernel and
plain version must agree bit for bit, ties included; `block_mips` at every
k up to n_pad, at 3% and 50% of the (query, slot) entries selected (its
chunks scored pair by pair and as a tile), with one query a page, at
B = 65, and with the Condition-A stop inside a chunk.
`mips_score` on float data and `sketch_scores` sum in another order than
their GEMM plain versions and are held to |d| <= 1e-5 * |q| |x| + 1e-6.
Both also have a bit-for-bit check of their own on float data: the
`mips_score` small-batch path (B <= the kernel's B_SMALL) against the tile
path's columns of the same batch padded past B_SMALL, and `sketch_scores`
against the ordered LUT sum `ref.sketch_scores_lut_ref`, at every
query-group size of the kernel (8, 4, 2 and 1, chosen by B).
`binary_probe_lb` is bit for bit on integer-valued projections (every
partial sum is exact) and within 1e-6 relative on float ones.
`decode_attention` sums scores, the softmax and P.V in another order than
its blocked plain version: held to |d| <= 1e-5 * max|v| + 1e-6 per row
(the output is a convex combination of V rows), with cache_len = 0 giving
the mean of V.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mips_score as ms
from repro_torch.kernels import ops
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _round_inputs(rng, nb, p, d, b, k, ns, dense, hit_q=0.97, sel_frac=None,
                  lone=False):
    """Integer-valued round inputs: padding slots, invalid rows, duplicate
    rows, a carried top-k with hits and empty (-inf, -1) tails; c_half at
    the ``hit_q`` quantile of each query's scores. ``sel_frac`` sets the
    share of selected (query, slot) entries; ``lone`` gives every slot
    exactly one selecting query."""
    n = nb * p
    x = rng.randint(-3, 4, (n, d)).astype(np.float32)
    dup = rng.choice(n, n // 8, replace=False)
    x[dup] = x[rng.choice(n, len(dup))]                      # exact ties
    valid = rng.rand(n) > 0.15
    q = rng.randint(-3, 4, (b, d)).astype(np.float32)
    if dense:
        slots = np.arange(nb, dtype=np.int32)
        sel = rng.rand(b, nb) > (0.3 if sel_frac is None else 1 - sel_frac)
    else:
        blocks = np.sort(rng.choice(nb, ns - 2, replace=False))
        slots = np.concatenate([blocks, [0, 0]]).astype(np.int32)
        sel = rng.rand(b, ns) > (0.4 if sel_frac is None else 1 - sel_frac)
        sel[:, ns - 2:] = False
    if lone:
        sel[:] = False
        n_real = len(slots) if dense else ns - 2
        sel[rng.randint(0, b, n_real), np.arange(n_real)] = True
    scores = q @ x.T
    c_half = (np.quantile(scores, hit_q, axis=1) + 0.5).astype(np.float32)
    init_s = np.sort(rng.randint(-10, 60, (b, k)).astype(np.float32),
                     axis=1)[:, ::-1].copy()
    init_r = rng.randint(0, n, (b, k)).astype(np.int32)
    tail = rng.randint(0, k + 1, b)
    for i in range(b):
        init_s[i, k - tail[i]:] = -np.inf
        init_r[i, k - tail[i]:] = -1
    return (x, valid, q, slots, sel, init_s, init_r, c_half)


def _stop_slots(args, cnt, k):
    """Per query, the slot at which the Condition-A scan stops (the first
    selected slot where the carried hits plus the earlier counts reach k),
    or -1 where it does not."""
    sel, init_s, c_half = args[4].cpu(), args[5].cpu(), args[7].cpu()
    cnt = cnt.cpu().long()
    n0 = (init_s >= c_half[:, None]).sum(dim=1)
    stop = sel & (n0[:, None] + torch.cumsum(cnt, dim=1) - cnt >= k)
    first = torch.where(stop.any(dim=1), stop.int().argmax(dim=1),
                        torch.full((sel.shape[0],), -1))
    return first


def _check_round(cuda, args, k, p, dense):
    args = [torch.from_numpy(a).to(cuda) for a in args]
    got = ops.block_mips(*args, k=k, page_rows=p, use_kernels=True)
    want = ops.block_mips(*args, k=k, page_rows=p, dense=dense,
                          use_kernels=False)
    torch.cuda.synchronize()
    for name, g, w in zip(("top_s", "top_r", "cnt", "pages", "cand"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                      err_msg=name)
    return args, got


@pytest.mark.parametrize("nb,p,d,b,k,ns,dense,extra", [
    (12, 8, 32, 5, 4, 8, False, {}),
    (30, 16, 64, 9, 10, 16, False, {}),
    (64, 21, 48, 70, 32, 40, False, {}),    # page_rows 21, two query tiles
    (20, 8, 128, 17, 1, 4, False, {}),
    (100, 1, 300, 3, 5, 64, False, {}),     # page_rows 1, depth in 3 slices
    (40, 64, 16, 2, 100, 40, True, {}),     # page_rows = tile rows
    (50, 32, 32, 5, 128, 50, True, {}),
    (300, 8, 128, 64, 10, 300, True, {}),   # the main path's widths
    (30, 8, 128, 4, 700, 30, True, {}),     # k above one chunk's rows
    # the main path's widths, about 3% of the entries selected (chunks
    # scored pair by pair), and about 50% (chunks scored as a tile)
    (4096, 8, 128, 64, 10, 4000, False, {"sel_frac": 0.03}),
    (2000, 8, 128, 64, 10, 2000, True, {"sel_frac": 0.5}),
    (512, 8, 128, 64, 10, 500, False, {"lone": True}),   # one query a page
    (600, 8, 128, 64, 1, 600, False, {"sel_frac": 0.03}),   # k = 1
    (700, 8, 64, 65, 10, 600, False, {"sel_frac": 0.2}),    # B = 65
    (800, 8, 64, 64, 10, 700, False, {"hit_q": 0.9, "sel_frac": 0.1}),  # stop
    (40, 8, 33, 6, 10, 30, False, {}),      # rows not 16-byte aligned
    (40, 8, 301, 5, 10, 30, False, {}),     # and queries not resident
])
def test_block_mips_kernel_bitwise_on_integer_data(cuda, nb, p, d, b, k, ns,
                                                   dense, extra):
    rng = np.random.RandomState(nb * 1000 + k)
    args, got = _check_round(cuda, _round_inputs(rng, nb, p, d, b, k, ns, dense,
                                                 **extra), k, p, dense)
    if extra.get("lone"):
        assert int(args[4].sum(dim=0).max()) == 1
    if "hit_q" in extra:   # the stop falls inside a chunk for some query
        stop = _stop_slots(args, got[2], k)
        assert bool(((stop >= 0) & (stop % (64 // p) != 0)).any())


@pytest.mark.parametrize("nb,p,d,b,k,ns,dense,hit_q,extra", [
    (600, 8, 32, 5, 1025, 400, False, 0.97, {}),
    (600, 8, 64, 9, 4096, 600, True, 0.97, {}),
    (300, 8, 16, 3, 2400, 300, True, 0.97, {}),     # k = n_pad
    (100, 21, 48, 4, 2100, 100, True, 0.97, {}),    # k = n_pad, page_rows 21
    (512, 8, 32, 66, 1025, 500, False, 0.5, {}),    # the Condition-A stop fires
    # either side of 1,024 (the earlier kernel's shared-memory merge) at
    # the main path's widths and about 3% selected
    (4096, 8, 128, 64, 1024, 4000, False, 0.97, {"sel_frac": 0.03}),
    (4096, 8, 128, 64, 1025, 4000, False, 0.97, {"sel_frac": 0.03}),
    (2000, 8, 128, 65, 1025, 2000, True, 0.97, {"sel_frac": 0.5}),
])
def test_block_mips_kernel_large_k_bitwise(cuda, nb, p, d, b, k, ns, dense,
                                           hit_q, extra):
    """k from 1,024 up to n_pad: the merge gives the plain version's rows
    and scores, ties (duplicate rows, carried against tile) included."""
    rng = np.random.RandomState(nb + k)
    args, got = _check_round(cuda, _round_inputs(rng, nb, p, d, b, k, ns, dense,
                                                 hit_q, **extra), k, p, dense)
    if hit_q < 0.9:
        assert bool((got[3] < args[4].sum(dim=1)).any()), "no stop fired"


def test_block_mips_kernel_rejects_what_it_does_not_take(cuda):
    rng = np.random.RandomState(0)
    args = [torch.from_numpy(a).to(cuda)
            for a in _round_inputs(rng, 12, 8, 32, 5, 4, 8, False)]
    with pytest.raises(ValueError):
        ops.block_mips(*args, k=4, page_rows=80, use_kernels=True)
    with pytest.raises(ValueError):
        ops.block_mips(*args, k=5, page_rows=8, use_kernels=True)  # init (B, 4)
    bad = list(args)
    bad[4] = bad[4].int()                                     # sel not bool
    with pytest.raises(ValueError):
        ops.block_mips(*bad, k=4, page_rows=8, use_kernels=True)


@pytest.mark.parametrize("b,nb,m,kcw,sub_d", [
    (64, 5000, 16, 256, 8), (5, 1000, 16, 191, 3), (13, 777, 8, 64, 4),
    (3, 500, 3, 32, 5)])                # M not a multiple of 4
def test_sketch_scores_kernel_within_tolerance(cuda, b, nb, m, kcw, sub_d):
    rng = np.random.RandomState(b + nb)
    q = torch.from_numpy(rng.standard_normal((b, m * sub_d)).astype(np.float32)).to(cuda)
    cb = torch.from_numpy(rng.standard_normal((m, kcw, sub_d)).astype(np.float32)).to(cuda)
    codes = torch.from_numpy(rng.randint(0, kcw, (nb, m)).astype(np.int32)).to(cuda)
    sk_mu = torch.cat([cb[s][codes[:, s].long()] for s in range(m)], dim=1)
    got = ops.sketch_scores(q, sk_mu, cb, codes, use_kernels=True)
    want = ops.sketch_scores(q, sk_mu, cb, codes, use_kernels=False)
    tol = (1e-5 * q.norm(dim=1)[:, None] * sk_mu.norm(dim=1)[None, :] + 1e-6)
    assert bool(((got - want).abs() <= tol).all())


# B picks the query group: 64 and 7 take groups of 8, 4 and 3 of 4, 2 of 2,
# 1 of 1
@pytest.mark.parametrize("b,nb,m,kcw,sub_d", [
    (1, 1000, 16, 256, 8), (7, 777, 8, 64, 4), (64, 5000, 16, 256, 8),
    (64, 1001, 8, 256, 16), (7, 333, 6, 32, 3),   # M % 4 != 0: scalar codes
    (3, 50, 3, 17, 2), (4, 2049, 16, 256, 8), (4, 777, 8, 64, 4),
    (2, 500, 16, 256, 8)])
def test_sketch_scores_kernel_bitwise_equals_ordered_lut(cuda, b, nb, m, kcw,
                                                         sub_d):
    rng = np.random.RandomState(b * 7 + nb)
    q = torch.from_numpy(rng.standard_normal((b, m * sub_d)).astype(np.float32)).to(cuda)
    cb = torch.from_numpy(rng.standard_normal((m, kcw, sub_d)).astype(np.float32)).to(cuda)
    codes = torch.from_numpy(rng.randint(0, kcw, (nb, m)).astype(np.int32)).to(cuda)
    sk_mu = torch.cat([cb[s][codes[:, s].long()] for s in range(m)], dim=1)
    want = ref.sketch_scores_lut_ref(q, cb, codes)
    before = ops.LAUNCHES["sketch_scores"]
    got = ops.sketch_scores(q, sk_mu, cb, codes, use_kernels=True)
    assert ops.LAUNCHES["sketch_scores"] == before + 1
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


# (B, d, R, offset): every small B at three depths (d % 4 != 0 included),
# ragged R, and x a contiguous view 4 bytes past a 16-byte boundary; B None
# stands for B_SMALL, which the kernel's library holds
SMALL_CASES = ([(b, d, 1037, 0) for b in (1, 2, 3, 4, 5, None)
                for d in (128, 130, 2048)]
               + [(4, 128, 777, 1), (3, 2048, 300, 1), (None, 130, 5000, 1),
                  (2, 128, 5, 0), (4, 2048, 32_000, 0)])


@pytest.mark.parametrize("b,d,r,offset", SMALL_CASES)
def test_mips_score_small_path_bitwise_equals_tile_path(cuda, b, d, r, offset):
    b_small = ms.b_small()
    b = b_small if b is None else b
    rng = np.random.RandomState(b * 1000 + d + r)
    flat = torch.from_numpy(rng.standard_normal(r * d + offset).astype(np.float32))
    x = flat.to(cuda)[offset:].view(r, d)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 * offset
    q = torch.from_numpy(rng.standard_normal((b_small + 1, d)).astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.rand(r) > 0.01).to(cuda)
    small = ops.mips_score(x, q[:b].contiguous(), valid, use_kernels=True)
    forced = ms._launch(x, q[:b].contiguous(), valid, ms.SMALL)
    tile = ops.mips_score(x, q, valid, use_kernels=True)[:, :b]
    forced_tile = ms._launch(x, q[:b].contiguous(), valid, ms.TILE)
    torch.cuda.synchronize()
    # the wrapper took the small path, and it equals the tile path's columns
    np.testing.assert_array_equal(small.cpu().numpy(), forced.cpu().numpy())
    np.testing.assert_array_equal(small.cpu().numpy(), tile.cpu().numpy())
    np.testing.assert_array_equal(small.cpu().numpy(), forced_tile.cpu().numpy())
    assert bool((small[~valid] == -1e30).all())
    want = ops.mips_score(x, q[:b].contiguous(), valid, use_kernels=False)
    tol = 1e-5 * x.norm(dim=1)[:, None] * q[:b].norm(dim=1)[None, :] + 1e-6
    assert bool(((small - want).abs() <= tol).all())


@pytest.mark.parametrize("r,b,d", [(1, 1, 1), (131, 7, 33), (1000, 64, 128),
                                   (300, 70, 300), (129, 65, 17)])
def test_mips_score_kernel_bitwise_on_integer_data(cuda, r, b, d):
    rng = np.random.RandomState(r + b + d)
    x = torch.from_numpy(rng.randint(-3, 4, (r, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.randint(-3, 4, (b, d)).astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.rand(r) > 0.2).to(cuda)
    got = ops.mips_score(x, q, valid, use_kernels=True)
    want = ops.mips_score(x, q, valid, use_kernels=False)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert bool((got[~valid] == -1e30).all())


@pytest.mark.parametrize("r,b,d", [(131_072, 64, 128), (777, 5, 48)])
def test_mips_score_kernel_within_tolerance(cuda, r, b, d):
    rng = np.random.RandomState(r)
    x = torch.from_numpy(rng.standard_normal((r, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.rand(r) > 0.01).to(cuda)
    got = ops.mips_score(x, q, valid, use_kernels=True)
    want = ops.mips_score(x, q, valid, use_kernels=False)
    tol = 1e-5 * x.norm(dim=1)[:, None] * q.norm(dim=1)[None, :] + 1e-6
    assert bool(((got - want).abs() <= tol).all())
    assert bool((got[~valid] == -1e30).all())


def test_mips_score_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((8, 4), device=cuda)
    q = torch.zeros((2, 4), device=cuda)
    valid = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        ops.mips_score(x, q, valid.int(), use_kernels=True)
    with pytest.raises(ValueError):
        ops.mips_score(x, q[:, :3].contiguous(), valid, use_kernels=True)
    with pytest.raises(ValueError):
        ops.mips_score(x.T, q, valid, use_kernels=True)


def test_mips_score_small_path_refuses_a_batch_above_b_small(cuda):
    b = ms.b_small() + 1
    x = torch.ones((64, 8), device=cuda)
    q = torch.ones((b, 8), device=cuda)
    valid = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(RuntimeError, match="mips_score launch failed"):
        ms._launch(x, q, valid, ms.SMALL)
    assert bool((ms._launch(x, q, valid, ms.TILE) == 8.0).all())


@pytest.mark.parametrize("b,g,m,integer", [
    (4, 256, 8, False), (64, 4493, 16, False), (3, 1000, 30, False),
    (5, 300, 1, False), (7, 2049, 12, True)])
def test_binary_probe_lb_kernel(cuda, b, g, m, integer):
    rng = np.random.RandomState(b * g + m)
    codes = torch.from_numpy(rng.randint(0, 2 ** m, g).astype(np.int64)).to(cuda)
    q_proj = (rng.randint(-4, 5, (b, m)) if integer
              else rng.standard_normal((b, m))).astype(np.float32)
    q_proj = torch.from_numpy(q_proj).to(cuda)
    q_code = torch.from_numpy(rng.randint(0, 2 ** m, b).astype(np.int64)).to(cuda)
    before = ops.LAUNCHES["binary_probe_lb"]
    got = ops.binary_probe_lb(codes, q_code, q_proj, use_kernels=True)
    want = ops.binary_probe_lb(codes, q_code, q_proj, use_kernels=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["binary_probe_lb"] == before + 1
    assert got.shape == (b, g) and got.dtype == torch.float32
    if integer:
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-6, atol=0)


def test_binary_probe_lb_kernel_rejects_what_it_does_not_take(cuda):
    codes = torch.zeros(8, dtype=torch.int64, device=cuda)
    q_code = torch.zeros(2, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):      # m > 30
        ops.binary_probe_lb(codes, q_code, torch.zeros((2, 31), device=cuda),
                            use_kernels=True)
    with pytest.raises(ValueError):      # int32 codes
        ops.binary_probe_lb(codes.int(), q_code, torch.zeros((2, 4), device=cuda),
                            use_kernels=True)


def _attention_inputs(rng, b, kh, g, dh, s, lens, cuda):
    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    return (t((b, kh, g, dh)), t((b, s, kh, dh)), t((b, s, kh, dh)),
            torch.tensor(lens, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("b,kh,g,dh,s,lens", [
    (4, 4, 8, 64, 512, [1, 37, 300, 512]),        # the serve shape
    (3, 2, 4, 32, 700, [0, 5, 700]),              # cache_len 0, S % 64 != 0
    (2, 1, 1, 128, 1, [1, 3]),                    # cache_len past S
    (2, 2, 32, 64, 3000, [2999, 1025]),
    (8, 4, 8, 64, 32768, [32768, 1, 20000, 4097, 64, 65, 31000, 12345]),
])
def test_decode_attention_kernel(cuda, b, kh, g, dh, s, lens):
    rng = np.random.RandomState(b * s + g)
    q, k, v, cache_len = _attention_inputs(rng, b, kh, g, dh, s, lens, cuda)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, cache_len, use_kernels=True)
    want = ops.decode_attention(q, k, v, cache_len, use_kernels=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    vmax = v.abs().amax(dim=(1, 3))                     # (B, dh) -> per row
    tol = 1e-5 * vmax.amax(dim=1)[:, None, None, None] + 1e-6
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())
    for i, n in enumerate(lens):
        if n == 0:                          # every position masked alike
            mean = v[i].mean(dim=0)         # (KH, dh)
            assert bool(((got[i] - mean[:, None]).abs() <= tol[i]).all())


def test_decode_attention_kernel_rejects_what_it_does_not_take(cuda):
    rng = np.random.RandomState(0)
    q, k, v, cache_len = _attention_inputs(rng, 2, 2, 4, 48, 10, [3, 4], cuda)
    with pytest.raises(ValueError):      # dh 48
        ops.decode_attention(q, k, v, cache_len, use_kernels=True)
    q, k, v, cache_len = _attention_inputs(rng, 2, 2, 4, 32, 10, [3, 4], cuda)
    with pytest.raises(ValueError):      # not contiguous
        ops.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                             v, cache_len, use_kernels=True)
    with pytest.raises(ValueError):      # bf16
        ops.decode_attention(q.bfloat16(), k, v, cache_len, use_kernels=True)
