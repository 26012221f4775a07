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
`quick_probe_select` (the fused Quick-Probe) gives its plain version's
representative rows, Test-A flags and radius bit for bit (both sum the m
squares in index order and round the root correctly), on exact ties,
padding groups, no group passing, m = 1 and m = 30, and at a round-1
sphere cut that a last-ulp radius difference would move; it is one launch
a call (under torch.profiler, between sentinel kernels, a session that
lost records taken again) and two calls are equal bit for bit.
The in-graph fused driver (`core/search_graph.py`) captures its stages as
CUDA graphs: replayed after the caller's query tensor changed in place it
equals the host driver bit for bit, with and without the kernels and under
a truncating cap, and each replay counts the kernels its graphs hold.
`decode_attention` sums scores, the softmax and P.V in another order than
its blocked plain version: held to |d| <= 1e-5 * max|v| + 1e-6 per row
(the output is a convex combination of V rows), with cache_len = 0 giving
the mean of V, at every head width it takes (a multiple of 8 up to 128:
dh 120 runs the dh-128 geometry with its last columns zero-filled). In bf16
(the f32 arithmetic inside, the output rounded to bf16) kernel and plain
version are within one bf16 ulp beyond the f32 bound of each other (an
output near zero can lie several of its own ulps away), the output is
bf16, and a dh it does not take, a mixed or another dtype raises
ValueError. Its sums run in an order fixed by the inputs, so repeated
calls are equal bit for bit; it is one CUDA launch a call and replays
from a CUDA graph after its inputs change in place. Its log-sum-exp output
(``return_lse``) comes with the output in f32, which rounded to the
input dtype is the output alone bit for bit; it is held to
|d| <= 1e-5 * max(1, |lse|) against the plain version's (1e-6 in bf16 and
at dh 120) and is -inf exactly where cache_len = 0; the kernel over a
sequence cut in two halves at their local lengths, merged by the log-sum-exp
(`attention.combine_pieces`), is held to the whole call's tolerance, and a
row whose length ends in the first half gets exactly that half's output
(the empty half weighs 0).
The serve engine's captured decode step (`serve.engine._DecodeGraph`, at
the reduced tinyllama config) equals the eager `decode_step` bit for bit
in its output and cache after the tokens and ``cache_len`` change in
place, counts its kernels at each replay, and after `update()` is
captured again over the engine's copy of the embed table, giving the
eager engine's tokens; a decode function that cannot be captured raises.
`scan_blocks` (the block walk of the scan and progressive searches) is held
bit for bit against its plain version on integer data, in both modes, from
an empty and from a carried round-1 top-k, at budgets that walk everything
and that truncate, with the Condition-A stop mid-walk and blocks skipped by
the progressive test; with one walk 100x the others', at B 1, 64 and 200
(below and above the SM count, B 200 in parts), with stops on a segment's
last and first step, at d 300 and 5,408, at every page_rows from 1 to 256,
from a carried top-k of ties, twice in a row on one reused scratch, and at
the largest k whose top-k fits in shared memory. `ops.mips_topk` on the card equals its plain route
on integer data on both of its routes (block_mips at k <= 128, mips_score
and a stable top-k above).
The sharded search runs on three padded shards of integer data (every
padding rule of `build_sharded` applies): `sharded_search` on the kernels
equals the plain versions on the card and on the CPU bit for bit in fused,
batched and progressive mode; each shard's `quick_probe_select` and
`sketch_scores` equal their plain versions; each shard's graphs are
captured once, and the fused sharded search equals the per-shard host
driver merged by the same rule; the streaming sharded index on the card
equals the CPU's after churn and a compaction.
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


def _attention_inputs(rng, b, kh, g, dh, s, lens, cuda, dtype=torch.float32):
    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda).to(dtype)
    return (t((b, kh, g, dh)), t((b, s, kh, dh)), t((b, s, kh, dh)),
            torch.tensor(lens, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("b,kh,g,dh,s,lens", [
    (4, 4, 8, 64, 512, [1, 37, 300, 512]),        # the serve shape
    (3, 2, 4, 32, 700, [0, 5, 700]),              # cache_len 0, S % 64 != 0
    (2, 1, 1, 128, 1, [1, 3]),                    # cache_len past S
    (2, 2, 32, 64, 3000, [2999, 1025]),
    (8, 4, 8, 64, 32768, [32768, 1, 20000, 4097, 64, 65, 31000, 12345]),
    (4, 4, 8, 64, 20000, [19000, 1, 0, 64]),     # one long row among short ones
    (3, 2, 8, 64, 40000, [1, 40000, 5]),          # rows whose chunks are past cache_len
    (2, 4, 1, 64, 9000, [9000, 4500]),            # G = 1 over many chunks
    (2, 2, 32, 128, 5000, [5000, 2500]),          # G = 32 (four row groups), dh 128
    (2, 2, 3, 32, 3000, [2999, 700]),             # G = 3 (a padded row group), dh 32
    (2, 1, 12, 64, 300, [300, 100]),              # G = 12 (a partial second group)
    (1, 4, 8, 64, 524288, [524288]),              # long_500k
    (4, 16, 1, 128, 512, [1, 41, 300, 512]),      # qwen2-moe / moonshot decode
    (4, 8, 2, 128, 512, [297, 300, 311, 512]),    # internvl2 decode (256 patches)
    (4, 32, 1, 64, 512, [25, 41, 300, 512]),      # zamba2's shared attention
    (4, 8, 4, 120, 512, [1, 37, 300, 512]),       # h2o-danube-3-4b decode, dh 120
    (8, 8, 4, 120, 32768, [32768, 1, 20000, 4097, 64, 65, 31000, 12345]),
    (3, 2, 8, 8, 700, [0, 5, 700]),               # dh 8, the smallest
    (2, 2, 5, 40, 3000, [2999, 1025]),            # dh 40 in the dh-64 geometry
    (2, 4, 8, 96, 9000, [9000, 4500]),            # dh 96 in the dh-128 geometry
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


@pytest.mark.parametrize("b,kh,g,dh,s,lens", [
    (4, 4, 8, 64, 512, [1, 37, 300, 512]),        # the serve shape
    (3, 2, 4, 32, 700, [0, 5, 700]),              # cache_len 0: lse -inf
    (8, 4, 8, 64, 32768, [32768, 1, 20000, 4097, 64, 65, 31000, 12345]),
    (2, 16, 1, 64, 4096, [4096, 513]),            # zamba2's shared block, 2 ranks
    (1, 4, 8, 64, 8192, [0]),                     # a rank's empty piece
    (4, 8, 4, 120, 4096, [4096, 513, 0, 2000]),   # h2o-danube-3-4b, 2 ranks
])
def test_decode_attention_kernel_lse(cuda, b, kh, g, dh, s, lens):
    rng = np.random.RandomState(b * s + g + 1)
    q, k, v, cache_len = _attention_inputs(rng, b, kh, g, dh, s, lens, cuda)
    before = ops.LAUNCHES["decode_attention"]
    got, lse = ops.decode_attention(q, k, v, cache_len, use_kernels=True,
                                    return_lse=True)
    assert ops.LAUNCHES["decode_attention"] == before + 1
    alone = ops.decode_attention(q, k, v, cache_len, use_kernels=True)
    want, want_lse = ops.decode_attention(q, k, v, cache_len,
                                          use_kernels=False, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(got, alone)
    assert lse.shape == (b, kh, g) and lse.dtype == torch.float32
    empty = torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(lse), empty)
    assert bool(empty.eq(cache_len[:, None, None] <= 0).all())
    d = (lse - want_lse)[~empty].abs()
    rel = 1e-5 if dh in (32, 64, 128) else 1e-6
    tol = rel * torch.clamp(want_lse[~empty].abs(), min=1.0)
    assert bool((d <= tol).all()), float(d.max()) if d.numel() else 0.0


def _bf16_ulp(got, want):
    """One bf16 ulp at the larger magnitude of the two, elementwise."""
    top = torch.maximum(got.float().abs(), want.float().abs())
    _, e = torch.frexp(top)
    return torch.ldexp(torch.ones_like(top), (e - 8).clamp(min=-133))


BF16_SHAPES = [
    (4, 4, 8, 64, 512, [1, 37, 300, 512]),        # the serve shape
    (4, 8, 8, 128, 512, [1, 37, 300, 512]),       # qwen3-32b decode
    (4, 8, 4, 120, 512, [1, 37, 300, 512]),       # h2o-danube-3-4b decode
    (3, 2, 4, 32, 700, [0, 5, 700]),              # dh 32: the dh-64 geometry
    (8, 4, 8, 64, 32768, [32768, 1, 20000, 4097, 64, 65, 31000, 12345]),
    (2, 2, 32, 128, 5000, [5000, 2500]),          # G = 32, dh 128
    (2, 1, 12, 120, 3000, [3000, 100]),           # G = 12, dh 120
    (1, 4, 8, 64, 524288, [524288]),              # long_500k
    (4, 16, 1, 128, 512, [1, 41, 300, 512]),      # qwen2-moe / moonshot decode
    (4, 32, 1, 64, 512, [25, 41, 300, 512]),      # zamba2's shared attention
]


@pytest.mark.parametrize("b,kh,g,dh,s,lens", BF16_SHAPES)
def test_decode_attention_kernel_bf16(cuda, b, kh, g, dh, s, lens):
    """bf16 q/k/v: the output bf16, each side the rounding of an f32 value
    (f32 inside, rounded once), so within one bf16 ulp beyond the f32 bound
    of each other; two calls equal bit for bit."""
    rng = np.random.RandomState(b * s + g + 2)
    args = _attention_inputs(rng, b, kh, g, dh, s, lens, cuda, torch.bfloat16)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(*args, use_kernels=True)
    want = ops.decode_attention(*args, use_kernels=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == args[0].shape
    vmax = args[2].float().abs().amax(dim=(1, 3))
    tol = 1e-5 * vmax.amax(dim=1)[:, None, None, None] + 1e-6
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol + _bf16_ulp(got, want)).all())
    assert torch.equal(ops.decode_attention(*args, use_kernels=True), got)


@pytest.mark.parametrize("b,kh,g,dh,s,lens", [
    (4, 8, 4, 120, 4096, [4096, 513, 0, 2000]),   # h2o-danube-3-4b, 2 ranks
    (8, 4, 8, 64, 32768, [32768, 1, 20000, 4097, 64, 65, 31000, 12345]),
    (2, 16, 1, 128, 4096, [4096, 513]),
])
def test_decode_attention_kernel_lse_bf16(cuda, b, kh, g, dh, s, lens):
    """The log-sum-exp instance in bf16: its f32 output rounds to the
    output alone bit for bit, and the log-sum-exp is within 1e-6
    max(1, |lse|) of the plain version's, -inf where cache_len = 0."""
    rng = np.random.RandomState(b * s + g + 3)
    args = _attention_inputs(rng, b, kh, g, dh, s, lens, cuda, torch.bfloat16)
    got, lse = ops.decode_attention(*args, use_kernels=True, return_lse=True)
    alone = ops.decode_attention(*args, use_kernels=True)
    want, want_lse = ops.decode_attention(*args, use_kernels=False,
                                          return_lse=True)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.to(torch.bfloat16), alone)
    vmax = args[2].float().abs().amax(dim=(1, 3))
    tol = 1e-5 * vmax.amax(dim=1)[:, None, None, None] + 1e-6
    assert bool(((got - want).abs() <= tol).all())
    empty = torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(lse), empty)
    d = (lse - want_lse)[~empty].abs()
    assert bool((d <= 1e-6 * torch.clamp(want_lse[~empty].abs(), min=1.0)).all())


def test_decode_attention_kernel_halves_merged(cuda):
    """The kernel on each half of the sequence at its local lengths, the
    halves merged by their log-sum-exps, against the kernel on the whole
    sequence; rows that end in the first half get its output exactly."""
    from repro_torch.models import attention
    rng = np.random.RandomState(7)
    b, kh, g, dh, s = 4, 4, 8, 64, 8192
    lens = [8192, 4096, 100, 6000]
    q, k, v, cache_len = _attention_inputs(rng, b, kh, g, dh, s, lens, cuda)
    whole = ops.decode_attention(q, k, v, cache_len, use_kernels=True)
    outs, lses = [], []
    for lo in (0, s // 2):
        part = torch.clamp(cache_len - lo, 0, s // 2)
        o, l = ops.decode_attention(q, k[:, lo:lo + s // 2].contiguous(),
                                    v[:, lo:lo + s // 2].contiguous(), part,
                                    use_kernels=True, return_lse=True)
        outs.append(o)
        lses.append(l)
    merged = attention.combine_pieces(torch.stack(outs), torch.stack(lses))
    torch.cuda.synchronize()
    vmax = v.abs().amax(dim=(1, 3))
    tol = 1e-5 * vmax.amax(dim=1)[:, None, None, None] + 1e-6
    assert bool(((merged - whole).abs() <= tol).all()), \
        float((merged - whole).abs().max())
    for i, n in enumerate(lens):
        if n <= s // 2:
            assert bool(torch.isneginf(lses[1][i]).all())
            assert torch.equal(merged[i], outs[0][i])


def test_decode_attention_kernel_rejects_what_it_does_not_take(cuda):
    rng = np.random.RandomState(0)
    for dh in (36, 136):                 # not a multiple of 8; past 128
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, cache_len = _attention_inputs(rng, 2, 2, 4, dh, 10, [3, 4],
                                                   cuda, dtype)
            with pytest.raises(ValueError, match="multiple of 8"):
                ops.decode_attention(q, k, v, cache_len, use_kernels=True)
    q, k, v, cache_len = _attention_inputs(rng, 2, 2, 4, 32, 10, [3, 4], cuda)
    with pytest.raises(ValueError):      # not contiguous
        ops.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                             v, cache_len, use_kernels=True)
    with pytest.raises(ValueError):      # bf16 q with f32 k / v
        ops.decode_attention(q.bfloat16(), k, v, cache_len, use_kernels=True)
    with pytest.raises(ValueError):      # f16
        ops.decode_attention(q.half(), k.half(), v.half(), cache_len,
                             use_kernels=True)


def test_decode_attention_kernel_is_deterministic(cuda):
    """Two calls on the same input are equal bit for bit: the partials are
    merged in chunk order whichever CTA finishes a row last."""
    rng = np.random.RandomState(5)
    args = _attention_inputs(rng, 8, 4, 8, 64, 32768,
                             [32768, 1, 20000, 4097, 64, 65, 31000, 0], cuda)
    first = ops.decode_attention(*args, use_kernels=True)
    for _ in range(3):
        assert torch.equal(ops.decode_attention(*args, use_kernels=True), first)


def test_decode_attention_kernel_in_a_cuda_graph(cuda):
    """A captured call, replayed after cache_len, K and V change in place,
    equals an eager call on the new values."""
    rng = np.random.RandomState(6)
    q, k, v, cache_len = _attention_inputs(rng, 4, 4, 8, 64, 4096,
                                           [4096, 1, 2000, 0], cuda)
    ops.decode_attention(q, k, v, cache_len, use_kernels=True)   # the tickets
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, cache_len, use_kernels=True)
    for lens in ([17, 4096, 0, 3000], [1, 1, 1, 1], [4096, 4096, 4096, 4096]):
        q2, k2, v2, len2 = _attention_inputs(rng, 4, 4, 8, 64, 4096, lens, cuda)
        for dst, src in ((q, q2), (k, k2), (v, v2), (cache_len, len2)):
            dst.copy_(src)
        graph.replay()
        want = ops.decode_attention(q, k, v, cache_len, use_kernels=True)
        torch.cuda.synchronize()
        assert torch.equal(out, want), lens


def test_decode_attention_kernel_graph_outlives_a_larger_eager_call(cuda):
    """An eager call that needs more tickets than the device's array holds
    gets a new array; a graph captured before it still replays correctly
    on the old one."""
    from repro_torch.kernels import decode_attention as da
    rng = np.random.RandomState(8)
    q, k, v, cache_len = _attention_inputs(rng, 4, 4, 8, 64, 4096,
                                           [4096, 1, 2000, 0], cuda)
    ops.decode_attention(q, k, v, cache_len, use_kernels=True)   # the tickets
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, cache_len, use_kernels=True)
    before = da._tickets[q.device.index]
    big_b = before.numel() // (4 * 32) + 1          # KH 4, G 32: outgrows it
    assert big_b <= da.B_MAX
    big = _attention_inputs(rng, big_b, 4, 32, 32, 64,
                            rng.randint(0, 65, big_b).tolist(), cuda)
    got = ops.decode_attention(*big, use_kernels=True)
    assert da._tickets[q.device.index].numel() > before.numel()
    want = ops.decode_attention(*big, use_kernels=False)
    tol = 1e-5 * big[2].abs().amax() + 1e-6
    assert float((got - want).abs().max()) <= float(tol)
    for lens in ([17, 4096, 0, 3000], [4096, 4096, 4096, 4096]):
        q2, k2, v2, len2 = _attention_inputs(rng, 4, 4, 8, 64, 4096, lens, cuda)
        for dst, src in ((q, q2), (k, k2), (v, v2), (cache_len, len2)):
            dst.copy_(src)
        graph.replay()
        want = ops.decode_attention(q, k, v, cache_len, use_kernels=True)
        torch.cuda.synchronize()
        assert torch.equal(out, want), lens


def test_decode_attention_kernel_on_two_streams(cuda):
    """Calls on two streams, queued back to back with no sync between them,
    each equal the same call made alone: the wrapper orders them, since
    they share the tickets."""
    rng = np.random.RandomState(9)
    inputs = [_attention_inputs(rng, 8, 4, 8, 64, 32768,
                                rng.randint(1, 32769, 8).tolist(), cuda)
              for _ in range(4)]
    alone = [ops.decode_attention(*a, use_kernels=True) for a in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    got = []
    for i, a in enumerate(inputs * 2):
        with torch.cuda.stream(streams[i % 2]):
            got.append(ops.decode_attention(*a, use_kernels=True))
    torch.cuda.synchronize()
    for i, out in enumerate(got):
        assert torch.equal(out, alone[i % 4]), i


def _cuda_kernels_of(fn, sessions=3):
    """The CUDA kernels and copies of one call of ``fn`` as torch.profiler
    sees them. The call sits between sentinel kernels (short spins, three
    before and one after): torch.profiler can drop the first records of
    a session, which the leading sentinels absorb. A
    session whose trace does not end with the trailing sentinel, or holds
    no record of the call, lost records and is taken again, up to
    ``sessions`` times (`chip_smoke.cuda_kernels_of`)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    for _ in range(sessions):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        kernels = [n for n in names if "spin_kernel" not in n]
        if names and "spin_kernel" in names[-1] and kernels:
            return kernels
    pytest.fail(f"torch.profiler lost records in {sessions} sessions in a "
                f"row (last trace: {names})")


def test_decode_attention_kernel_is_one_launch(cuda):
    """One CUDA kernel per call, as the profiler sees it."""
    rng = np.random.RandomState(7)
    args = _attention_inputs(rng, 8, 4, 8, 64, 32768,
                             [32768, 1, 20000, 4097, 64, 65, 31000, 12345], cuda)
    ops.decode_attention(*args, use_kernels=True)   # build, tickets
    kernels = _cuda_kernels_of(
        lambda: ops.decode_attention(*args, use_kernels=True))
    assert len(kernels) == 1 and "da_kernel" in kernels[0], kernels


def _probe_table(rng, g, m, b, flavor):
    """A group table, a batch and x_p for `quick_probe_select` (numpy, as
    `tests/test_torch_quick_probe.py` makes them against JAX)."""
    if 2 ** m <= 4 * g:
        codes = rng.choice(2 ** m, g, replace=False)
    else:
        codes = rng.permutation(np.unique(rng.randint(0, 2 ** m, 2 * g)))[:g]
    if flavor == "ties":
        q_proj = rng.choice([-2.0, 2.0], (b, m)).astype(np.float32)
        min_l1 = np.full(g, 3.0, np.float32)
        q_l1 = np.full(b, 4.0, np.float32)
    else:
        q_proj = rng.standard_normal((b, m)).astype(np.float32)
        min_l1 = rng.uniform(0.5, 4.0, g).astype(np.float32)
        q_l1 = np.abs(q_proj).sum(axis=1).astype(np.float32)
    count = rng.randint(1, 50, g).astype(np.int32)
    if flavor == "padding":
        pad = rng.rand(g) < 0.3
        count[pad], min_l1[pad] = 0, 1e-3
    table = (np.sort(codes).astype(np.int64), min_l1, count,
             rng.standard_normal((g, m)).astype(np.float32),
             rng.permutation(10 * g)[:g].astype(np.int32))
    if flavor == "none pass":
        return table, q_proj, q_l1, 1e9
    # x_p in the middle of the widest gap between the tested values near
    # their 70% quantile: some groups pass, and none is within an ulp of it
    bits = ((table[0][None, :] ^ ((q_proj >= 0) << np.arange(m)).sum(1)[:, None]
             )[..., None] >> np.arange(m)) & 1
    lb = (bits * np.abs(q_proj)[:, None, :]).sum(-1) / np.sqrt(m)
    val = np.sort((lb ** 2 / (0.9 * (min_l1[None, :] + q_l1[:, None]) ** 2))
                  .ravel())
    lo, hi = int(0.6 * val.size), max(int(0.8 * val.size), int(0.6 * val.size) + 2)
    i = lo + int(np.argmax(np.diff(val[lo:hi])))
    return table, q_proj, q_l1, float(val[i] + val[i + 1]) / 2


@pytest.mark.parametrize("g,m,b,flavor", [
    (200, 8, 6, "ties"), (300, 12, 8, "padding"), (100, 10, 5, "none pass"),
    (2, 1, 4, "float"), (1000, 30, 4, "float"), (4493, 16, 64, "float"),
    (256, 8, 4, "float")])
def test_quick_probe_select_kernel(cuda, g, m, b, flavor):
    rng = np.random.RandomState(g + m + b)
    table, q_proj, q_l1, x_p = _probe_table(rng, g, m, b, flavor)
    args = ([torch.from_numpy(t).to(cuda) for t in table]
            + [torch.from_numpy(q_proj).to(cuda), torch.from_numpy(q_l1).to(cuda),
               0.9, x_p])
    before = ops.LAUNCHES["quick_probe_select"]
    got = ops.quick_probe_select(*args, use_kernels=True)
    again = ops.quick_probe_select(*args, use_kernels=True)
    want = ops.quick_probe_select(*args, use_kernels=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["quick_probe_select"] == before + 2
    for a, w in zip(got, again):
        assert torch.equal(a, w)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    assert torch.equal(got[0], want[0]), "rep_row"
    assert torch.equal(got[2], want[2]), "test_a_passed"
    # the radius: the same squares, summed in the same index order, the
    # same correctly rounded root
    assert torch.equal(got[1], want[1]), "radius"
    if flavor == "none pass":
        assert not bool(got[2].any())
    else:
        assert bool(got[2].any())
    if flavor == "padding":
        rows = table[4][table[2] == 0]
        assert not np.isin(got[0].cpu().numpy(), rows).any()


def test_quick_probe_select_kernel_is_one_launch_and_rejects(cuda):
    rng = np.random.RandomState(3)
    table, q_proj, q_l1, x_p = _probe_table(rng, 4493, 16, 64, "float")
    t = [torch.from_numpy(a).to(cuda) for a in table]
    q = [torch.from_numpy(q_proj).to(cuda), torch.from_numpy(q_l1).to(cuda)]
    ops.quick_probe_select(*t, *q, 0.9, x_p, use_kernels=True)
    kernels = _cuda_kernels_of(
        lambda: ops.quick_probe_select(*t, *q, 0.9, x_p, use_kernels=True))
    assert len(kernels) == 1 and "quick_probe_kernel" in kernels[0], kernels
    with pytest.raises(ValueError):          # int32 codes
        ops.quick_probe_select(t[0].int(), *t[1:], *q, 0.9, x_p,
                               use_kernels=True)
    with pytest.raises(ValueError):          # m > 30
        ops.quick_probe_select(t[0], t[1], t[2],
                               torch.zeros((4493, 31), device=cuda), t[4],
                               torch.zeros((64, 31), device=cuda), q[1], 0.9,
                               x_p, use_kernels=True)


def test_quick_probe_select_radius_at_a_sphere_cut(cuda):
    """Where a sub-partition's distance equals the plain radius plus its own
    radius exactly (the round-1 cut of `search_common.sphere_select`), the
    kernel's radius selects it too: the two radii are equal bit for bit.
    A radius an ulp off (a torch reduction's sum order) could drop it."""
    from repro_torch.core.search_common import sphere_select
    rng = np.random.RandomState(57)
    table, q_proj, q_l1, x_p = _probe_table(rng, 4493, 16, 64, "float")
    args = ([torch.from_numpy(t).to(cuda) for t in table]
            + [torch.from_numpy(q_proj).to(cuda),
               torch.from_numpy(q_l1).to(cuda), 0.9, x_p])
    got = ops.quick_probe_select(*args, use_kernels=True)
    want = ops.quick_probe_select(*args, use_kernels=False)
    assert torch.equal(got[1], want[1])
    sp_radius = torch.from_numpy(rng.uniform(0.5, 3.0, 256).astype(
        np.float32)).to(cuda)
    d_sp = want[1][:, None] + sp_radius[None, :]         # exactly at the cut
    sel_p = sphere_select(d_sp, sp_radius[None, :], want[1][:, None])
    sel_k = sphere_select(d_sp, sp_radius[None, :], got[1][:, None])
    assert bool(sel_p.all()) and torch.equal(sel_k, sel_p)
    below = torch.nextafter(want[1], torch.zeros_like(want[1]))
    assert not bool(sphere_select(d_sp, sp_radius[None, :],
                                  below[:, None]).all()), \
        "the cut is an exact tie: an ulp less radius drops a sub-partition"


@pytest.fixture(scope="module")
def card_index():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.core.promips import ProMIPS
    from repro_torch.data.synthetic import mf_factors
    x = mf_factors(20000, 64, 12, decay=0.5, norm_tail=0.6, seed=0)
    pm = ProMIPS.build(x, m=12, c=0.9, p=0.6, norm_strata=4, seed=0,
                       device="cuda")
    qs = [torch.from_numpy(mf_factors(32, 64, 12, decay=0.5, seed=s)).cuda()
          for s in (1, 2, 3)]
    return pm, qs


GRAPH_CASES = {
    "kernels, prefilter": dict(use_kernels=None, prefilter=True,
                               prefilter_eps=0.1, dense_frac=0.8),
    "plain versions": dict(use_kernels=False, prefilter=True,
                           prefilter_eps=0.3),
    "kernels, truncating cap": dict(use_kernels=None, tile_cap=48),
}


def _assert_same(got, want, what):
    assert torch.equal(got[0], want[0]), f"{what}: ids"
    assert torch.equal(got[1], want[1]), f"{what}: scores"
    for field, a, w in zip(want[2]._fields, got[2], want[2]):
        assert torch.equal(a, w), f"{what}: {field}"


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_search_graph_replays_equal_the_host_driver(cuda, card_index, case):
    """Four searches with one query tensor, changed in place before the
    third: the first runs each stage eagerly, the second captures and
    replays, the rest replay. Each equals the host driver bit for bit."""
    from repro_torch.core import search_graph as sg
    from repro_torch.core.search_fused import search_batch_fused
    pm, qs = card_index
    nb = pm.meta.n_blocks
    knobs = dict(k=10, budget=nb, budget2=nb, **GRAPH_CASES[case])
    q = qs[0].clone()
    for i, src in enumerate((qs[0], qs[0], qs[1], qs[2])):
        q.copy_(src)
        got = sg.search_batch_fused_graph(pm.arrays, pm.meta, q, **knobs)
        want = search_batch_fused(pm.arrays, pm.meta, src.clone(), **knobs)
        torch.cuda.synchronize()
        _assert_same(got, want, f"search {i}")
        if "cap" in case:
            assert bool(want[2].exhausted.any()), "the cap truncated nothing"
    entry = next(e for key, e in sg._GRAPHS.items() if e.arrays is pm.arrays
                 and e.cfg.on_kernels == (knobs["use_kernels"] is None)
                 and e.cfg.prefilter == knobs.get("prefilter", False))
    assert ("front",) in entry.graphs and len(entry.graphs) >= 3


def test_search_graph_counts_the_kernels_of_each_replay(cuda, card_index):
    """After the graphs exist, N searches count N times the kernels the
    replayed graphs hold: one Quick-Probe, one sketch and two block_mips
    launches a search."""
    from repro_torch.core import search_graph as sg
    pm, qs = card_index
    nb = pm.meta.n_blocks
    knobs = dict(k=10, budget=nb, budget2=nb, prefilter=True,
                 prefilter_eps=0.1, dense_frac=0.8)
    for _ in range(2):
        sg.search_batch_fused_graph(pm.arrays, pm.meta, qs[0], **knobs)
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    n = 3
    for _ in range(n):
        sg.search_batch_fused_graph(pm.arrays, pm.meta, qs[0], **knobs)
    torch.cuda.synchronize()
    delta = {k: ops.LAUNCHES[k] - before[k] for k in before}
    assert delta == {"binary_probe_lb": 0, "block_mips": 2 * n,
                     "decode_attention": 0, "mips_score": 0,
                     "quick_probe_select": n, "scan_blocks": 0,
                     "sketch_scores": n}, delta


# -- the serve engine's captured decode step ----------------------------------

@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode step is captured on it")
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("tinyllama-1.1b").reduced()
    return cfg, T.init_params(cfg, seed=0, device="cuda")


def _filled_cache(cfg, b, s, lens, seed):
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, b, s, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name in ("k", "v"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=gen,
                                      device="cuda"))
    cache["len"].copy_(torch.tensor(lens, dtype=torch.int32))
    return cache


def _tokens(cfg, b, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(1, cfg.vocab, (b, 1)).astype(
        np.int32)).cuda()


@pytest.mark.parametrize("hidden", [False, True], ids=["logits", "hidden"])
@pytest.mark.parametrize("use_kernels", [None, False], ids=["kernel", "plain"])
def test_decode_graph_replays_bit_equal_to_eager(cuda, card_model, hidden,
                                                 use_kernels):
    """Five calls of one `_DecodeGraph` (eager, capture and replay, then
    replays), with new tokens every call and ``cache_len`` changed in place
    before the fourth: each output and the cache equal an eager
    `decode_step` on a copy of the cache bit for bit."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as engine_lib
    cfg, params = card_model
    cache = _filled_cache(cfg, 4, 64, [1, 17, 40, 63], seed=1)
    ref_cache = {name: t.clone() for name, t in cache.items()}
    ids = {name: id(t) for name, t in cache.items()}
    g = engine_lib._DecodeGraph(engine_lib._eager_decode(cfg, hidden,
                                                         use_kernels))
    for i in range(5):
        if i == 3:
            for c in (cache, ref_cache):
                c["len"].copy_(torch.tensor([5, 0, 30, 2], dtype=torch.int32))
        tok = _tokens(cfg, 4, seed=10 + i)
        got, got_cache = g(params, cache, tok)
        want, _ = T.decode_step(params, cfg, ref_cache, tok,
                                return_hidden=hidden, use_kernels=use_kernels)
        torch.cuda.synchronize()
        assert got_cache is cache
        assert {name: id(t) for name, t in cache.items()} == ids
        assert torch.equal(got, want), f"call {i}"
        for name in ("len", "k", "v"):
            assert torch.equal(cache[name], ref_cache[name]), (i, name)
    assert g.captures == 1 and g.graph is not None


def test_decode_graph_counts_the_kernels_of_each_replay(cuda, card_model):
    """Once captured, N calls count N x n_layers `decode_attention`
    launches, and the plain path's graph none."""
    from repro_torch.serve import engine as engine_lib
    cfg, params = card_model
    for use_kernels, per_call in ((None, cfg.n_layers), (False, 0)):
        cache = _filled_cache(cfg, 4, 64, [3, 9, 27, 50], seed=2)
        g = engine_lib._DecodeGraph(engine_lib._eager_decode(cfg, False,
                                                             use_kernels))
        for i in range(2):
            g(params, cache, _tokens(cfg, 4, seed=i))
        torch.cuda.synchronize()
        assert g.captures == 1
        assert g.tally == ({"decode_attention": cfg.n_layers} if per_call
                           else {})
        before = dict(ops.LAUNCHES)
        n = 3
        for i in range(n):
            g(params, cache, _tokens(cfg, 4, seed=5 + i))
        torch.cuda.synchronize()
        delta = {k: ops.LAUNCHES[k] - before[k] for k in before}
        assert delta == dict({k: 0 for k in before},
                             decode_attention=n * per_call), delta


@pytest.mark.parametrize("s", [1, 40])
def test_apply_moe_on_the_card_is_deterministic(cuda, s):
    """The MoE layer (gather dispatch, combine in sort order) twice on one
    input, at the qwen2-moe reduced config, decode and prefill shapes (at
    S 40 pairs drop): equal bit for bit, and within 1e-5 of the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    params = moe.init_moe(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    x = torch.from_numpy(np.random.RandomState(s).standard_normal(
        (4, s, cfg.d_model)).astype(np.float32))
    want, want_aux = moe.apply_moe(params, cfg, x)
    p_card = {k: (v.cuda() if torch.is_tensor(v) else
                  {kk: vv.cuda() for kk, vv in v.items()})
              for k, v in params.items()}
    outs = [moe.apply_moe(p_card, cfg, x.cuda()) for _ in range(3)]
    torch.cuda.synchronize()
    for out, aux in outs[1:]:
        assert torch.equal(out, outs[0][0]) and torch.equal(aux, outs[0][1])
    got = outs[0][0].cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "whisper-base",
                                  "internvl2-2b"])
def test_decode_graph_of_the_new_families_bit_equal_to_eager(cuda, name):
    """One `_DecodeGraph` over a reduced MoE, encoder-decoder or vision
    model's cache (the encoder K/V in it): four calls, each equal to an
    eager `decode_step` on a copy of the cache bit for bit, one capture,
    `decode_attention` counted once a layer at each replay."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as engine_lib
    cfg = get_config(name).reduced()
    params = T.init_params(cfg, seed=0, device="cuda")
    cache = T.init_cache(cfg, 4, 64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for key, t in cache.items():
        if t.dtype == torch.float32:
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    cache["len"].copy_(torch.tensor([1, 17, 40, 63], dtype=torch.int32))
    if "enc_len" in cache:
        cache["enc_len"].fill_(cfg.frontend_len)
    ref_cache = {key: t.clone() for key, t in cache.items()}
    g = engine_lib._DecodeGraph(engine_lib._eager_decode(cfg, False, None))
    for i in range(4):
        tok = _tokens(cfg, 4, seed=20 + i)
        before = ops.LAUNCHES["decode_attention"]
        got, _ = g(params, cache, tok)
        want, _ = T.decode_step(params, cfg, ref_cache, tok)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"call {i}"
        for key in cache:
            assert torch.equal(cache[key], ref_cache[key]), (i, key)
        if i >= 2:      # a replay counts its layers' launches
            assert ops.LAUNCHES["decode_attention"] - before == 2 * cfg.n_layers
    assert g.captures == 1


@pytest.mark.parametrize("mode", ["exact", "promips"])
def test_decode_graph_after_update_reads_the_new_rows(cuda, card_model, mode):
    """A card engine (graphs) and the same engine with its eager decode
    functions get the same traffic and two embedding refreshes while
    requests are in flight: equal tokens. The first refresh copies the
    table and the graph is captured again over the copy; the second writes
    into the copy in place, which the graph reads without a capture."""
    from repro_torch.serve import DecodeEngine
    cfg, params = card_model
    caller_embed = params["embed"].clone()
    kw = dict(batch_slots=3, max_len=64, result_cache=0, max_refill=None,
              logits_mode=mode, device="cuda")
    graph_eng = DecodeEngine(params, cfg, **kw)
    eager_eng = DecodeEngine(params, cfg, **kw)
    variant = "_decode_hidden" if mode == "promips" else "_decode"
    g = getattr(graph_eng, variant)
    setattr(eager_eng, variant, g.step)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab, size=6 + i % 3).astype(np.int32)
               for i in range(6)]
    reqs = [[e.submit(p, max_new_tokens=10) for p in prompts]
            for e in (graph_eng, eager_eng)]
    captures = []
    for phase in range(3):
        for _ in range(4):
            graph_eng.step()
            eager_eng.step()
        captures.append(g.captures)
        if phase == 2:
            break
        emitted = sorted({t for r in reqs[0] for t in r.out_tokens if t})
        ids = [emitted[phase]]
        rows = (rng.standard_normal((1, cfg.d_model)) * 0.05).astype(np.float32)
        for e in (graph_eng, eager_eng):
            e.update(ids, rows)
    graph_eng.run()
    eager_eng.run()
    assert [r.out_tokens for r in reqs[0]] == [r.out_tokens for r in reqs[1]]
    assert captures == [1, 2, 2] and g.captures == 2
    assert torch.equal(params["embed"], caller_embed)
    for e in (graph_eng, eager_eng):
        e.join_compaction()


def test_decode_graph_capture_that_fails_raises(cuda, card_model):
    """A decode function that reads a value on the host cannot be captured:
    the call that would capture it raises (no eager fallback), every later
    call raises too, and the eager first call is unaffected."""
    from repro_torch.serve import engine as engine_lib
    cfg, params = card_model
    eager = engine_lib._eager_decode(cfg, False, None)

    def step(params, cache, token):
        out, cache = eager(params, cache, token)
        out.sum().item()                     # a host read
        return out, cache

    cache = _filled_cache(cfg, 4, 64, [3, 9, 27, 50], seed=4)
    g = engine_lib._DecodeGraph(step)
    g(params, cache, _tokens(cfg, 4, seed=0))           # eager
    for i in range(2):
        with pytest.raises(RuntimeError):
            g(params, cache, _tokens(cfg, 4, seed=1 + i))
        assert g.graph is None and g.captures == 0
    torch.cuda.synchronize()


# ---------------------------------------------------------------- scan_blocks

def _walk_inputs(rng, nb, p, d, b, k, progressive, carried, stop_q=0.999,
                 sel_frac=0.3):
    """Integer-valued inputs of one block walk (exact scores, exact ties):
    padding rows, duplicate rows, c_half at the ``stop_q`` quantile of each
    query's scores. Scan mode: a random selection, its order and n_sel.
    Progressive mode: gaps in [0, 40), about the radii of the running k-th
    score, so blocks drop out as it grows. ``carried`` starts from a round-1
    top-k of random rows (some queries already at c_half)."""
    n = nb * p
    x = rng.randint(-3, 4, (n, d)).astype(np.float32)
    dup = rng.choice(n, n // 8, replace=False)
    x[dup] = x[rng.choice(n, len(dup))]
    ids = np.where(rng.rand(n) > 0.1, np.arange(n), -1).astype(np.int32)
    q = rng.randint(-3, 4, (b, d)).astype(np.float32)
    s = q @ x.T
    c_half = np.quantile(s, stop_q, axis=1).astype(np.float32)
    init_s = np.full((b, k), -np.inf, np.float32)
    init_r = np.full((b, k), -1, np.int32)
    if carried:
        live = np.nonzero(ids >= 0)[0]
        for i in range(b):
            m = min(k, len(live) // 2)
            m = m if i % 3 else max(1, m // 2)                # some tails empty
            rows = np.sort(rng.choice(live, m, replace=False))
            sc = s[i, rows]
            o = np.argsort(-sc, kind="stable")
            init_s[i, :m], init_r[i, :m] = sc[o], rows[o]
        init_s[0, :] = np.maximum(init_s[0, :], c_half[0])   # done at the start
    args = dict(x=x, ids=ids, q=q, init_scores=init_s, init_rows=init_r,
                c_half=c_half)
    if progressive:
        gap = rng.uniform(0, 40, (b, nb)).astype(np.float32)
        args.update(order=np.argsort(gap, axis=1, kind="stable").astype(np.int32),
                    block_gap=gap,
                    block_max_l2sq=rng.uniform(0, 2 * d * 4, nb).astype(np.float32),
                    q_l2sq=(q * q).sum(1).astype(np.float32))
    else:
        mask = rng.rand(b, nb) < sel_frac
        args.update(order=np.argsort(~mask, axis=1, kind="stable").astype(np.int32),
                    n_sel=mask.sum(1).astype(np.int32))
    return args


def _check_walk(cuda, args, **kw):
    t = {name: torch.from_numpy(a).to(cuda) for name, a in args.items()}
    pos = [t.pop(n) for n in ("x", "ids", "q", "order", "init_scores",
                              "init_rows", "c_half")]
    got = ops.scan_blocks(*pos, **t, **kw, use_kernels=True)
    want = ops.scan_blocks(*pos, **t, **kw, use_kernels=False)
    torch.cuda.synchronize()
    for name, g, w in zip(("top_s", "top_r", "pages", "cand", "done_a"), got,
                          want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                      err_msg=name)
    return got


@pytest.mark.parametrize("progressive", [False, True], ids=["scan", "progressive"])
@pytest.mark.parametrize("carried", [False, True], ids=["round1", "carried"])
@pytest.mark.parametrize("nb,p,d,b,k,budget", [
    (200, 8, 128, 64, 10, 200),      # the main path's widths, full budget
    (200, 8, 128, 64, 10, 37),       # a budget that truncates
    (300, 8, 128, 5, 1, 300),        # k = 1
    (60, 32, 32, 7, 33, 60),         # page_rows 32 (d = 32)
    (50, 1, 300, 3, 5, 50),          # page_rows 1, depth in 5 slices
    (40, 64, 16, 4, 100, 40),        # k above a page
    (20, 256, 4, 3, 10, 20),         # one block a chunk
    (30, 8, 33, 6, 700, 30),         # k above a chunk's rows, d odd
    (100, 8, 64, 3, 2058, 100),      # the stream's over-fetched k
])
def test_scan_blocks_kernel_bitwise_on_integer_data(cuda, progressive, carried,
                                                   nb, p, d, b, k, budget):
    rng = np.random.RandomState(nb * 7 + k + int(progressive))
    args = _walk_inputs(rng, nb, p, d, b, k, progressive, carried)
    for cs in ([False, True] if progressive else [False]):
        kw = dict(k=k, page_rows=p, budget=budget)
        if progressive:
            kw.update(c=0.9, x_p=7.0, cs_prune=cs)
        got = _check_walk(cuda, args, **kw)
    if carried:
        assert bool(got[4][0]) and int(got[2][0]) == 0   # stopped before a step


def test_scan_blocks_kernel_stops_and_skips(cuda):
    """The Condition-A stop fires mid-walk for some queries, and in
    progressive mode some blocks are skipped under the running k-th
    score."""
    rng = np.random.RandomState(5)
    args = _walk_inputs(rng, 400, 8, 64, 32, 10, False, False, stop_q=0.99,
                        sel_frac=0.9)
    got = _check_walk(cuda, args, k=10, page_rows=8, budget=400)
    n_sel = torch.from_numpy(args["n_sel"]).to(cuda)
    assert bool((got[4] & (got[2] < n_sel)).any()), "no stop fired"
    args = _walk_inputs(rng, 400, 8, 64, 32, 10, True, False, stop_q=1.0)
    got = _check_walk(cuda, args, k=10, page_rows=8, budget=400, c=0.9,
                      x_p=7.0, cs_prune=True)
    assert bool((got[2] < 400).any()), "no block was skipped"


def test_scan_blocks_kernel_rejects_what_it_does_not_take(cuda):
    rng = np.random.RandomState(0)
    args = _walk_inputs(rng, 20, 8, 32, 3, 4, False, False)
    t = {name: torch.from_numpy(a).to(cuda) for name, a in args.items()}
    pos = [t.pop(n) for n in ("x", "ids", "q", "order", "init_scores",
                              "init_rows", "c_half")]
    with pytest.raises(ValueError):                       # page_rows
        ops.scan_blocks(*pos, **t, k=4, page_rows=16, budget=20,
                        use_kernels=True)
    with pytest.raises(ValueError, match="shared memory"):
        big = [a for a in pos]
        big[4] = torch.full((3, 40_000), float("-inf"), device=cuda)
        big[5] = torch.full((3, 40_000), -1, dtype=torch.int32, device=cuda)
        ops.scan_blocks(*big, **t, k=40_000, page_rows=8, budget=20,
                        use_kernels=True)
    with pytest.raises(ValueError):                       # neither mode
        ops.scan_blocks(*pos, k=4, page_rows=8, budget=20, use_kernels=True)
    # the largest k whose top-k fits beside the staging ring runs; one more
    # is refused
    from repro_torch.kernels import build
    lib = build.library()
    k_max = (lib.scan_blocks_max_smem() - lib.scan_blocks_smem_bytes(32, 0)) // 8
    assert lib.scan_blocks_smem_bytes(32, k_max) <= lib.scan_blocks_max_smem()
    big = [a for a in pos]
    big[4] = torch.full((3, k_max + 1), float("-inf"), device=cuda)
    big[5] = torch.full((3, k_max + 1), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.scan_blocks(*big, **t, k=k_max + 1, page_rows=8, budget=20,
                        use_kernels=True)
    big[4], big[5] = big[4][:, :k_max].contiguous(), big[5][:, :k_max].contiguous()
    got = ops.scan_blocks(*big, **t, k=k_max, page_rows=8, budget=20,
                          use_kernels=True)
    want = ops.scan_blocks(*big, **t, k=k_max, page_rows=8, budget=20,
                           use_kernels=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _walk_kw(args, k, p, budget, progressive):
    kw = dict(k=k, page_rows=p, budget=budget)
    if progressive:
        kw.update(c=0.9, x_p=7.0, cs_prune=True)
    return kw


@pytest.mark.parametrize("progressive", [False, True], ids=["scan", "progressive"])
def test_scan_blocks_kernel_one_walk_a_hundred_times_longer(cuda, progressive):
    """Query 0 walks about 100x the blocks the others walk (scan: its
    selection; progressive: the blocks that qualify), no stop."""
    rng = np.random.RandomState(11)
    nb, p = 4000, 8
    args = _walk_inputs(rng, nb, p, 32, 64, 10, progressive, False,
                        sel_frac=0.01)
    args["c_half"][:] = np.float32(1e9)
    if progressive:
        args["block_gap"][1:] = np.float32(1e6)
        args["block_gap"][1:, rng.choice(nb, 40, replace=False)] = 0.0
        args["block_gap"][0] = 0.0
        args["order"] = np.argsort(args["block_gap"], axis=1,
                                   kind="stable").astype(np.int32)
    else:
        args["n_sel"][0] = nb
        args["order"][0] = np.arange(nb, dtype=np.int32)
    got = _check_walk(cuda, args, **_walk_kw(args, 10, p, nb, progressive))
    pages = got[2].cpu().numpy()
    assert pages[0] >= 50 * np.median(pages[1:]), pages[:8]


@pytest.mark.parametrize("b", [1, 64, 200])
def test_scan_blocks_kernel_below_and_above_the_sm_count(cuda, b, monkeypatch):
    """B 1, 64 and 200 (B = 200 walked in parts of 64 through a small
    scratch cap, one launch counted a part), both modes, from a carried
    top-k."""
    from repro_torch.kernels import build
    from repro_torch.kernels import scan_blocks as sb
    nb, p = 300, 8
    parts = 1
    if b == 200:
        per_query = build.library().scan_blocks_scratch_bytes(1, nb, p, nb)
        monkeypatch.setattr(sb, "SCRATCH_CAP", 64 * per_query)
        parts = 4
    for progressive in (False, True):
        rng = np.random.RandomState(b + int(progressive))
        args = _walk_inputs(rng, nb, p, 64, b, 10, progressive, True)
        before = ops.LAUNCHES["scan_blocks"]
        _check_walk(cuda, args, **_walk_kw(args, 10, p, nb, progressive))
        assert ops.LAUNCHES["scan_blocks"] == before + parts


@pytest.mark.parametrize("progressive", [False, True], ids=["scan", "progressive"])
def test_scan_blocks_kernel_stops_on_segment_boundaries(cuda, progressive):
    """Condition A stops each query exactly on the last or the first step
    of a segment (32 steps at page_rows 8): that step's block holds the
    query's k = 8 best rows, scoring exactly c_half."""
    rng = np.random.RandomState(17 + int(progressive))
    nb, p, d, b, k = 200, 8, 32, 8, 8
    args = _walk_inputs(rng, nb, p, d, b, k, progressive, False)
    targets = [31, 32, 63, 64, 95, 96, 127, 128]
    # query i meets block i (its k best rows) at step targets[i]
    args["order"] = np.stack([
        np.insert(rng.permutation(np.delete(np.arange(nb), i)), t, i)
        for i, t in enumerate(targets)]).astype(np.int32)
    if progressive:                 # every block qualifies at every step
        args["block_gap"][:] = 0.0
        args["block_max_l2sq"][:] = np.float32(1e6)
    else:
        args["n_sel"][:] = nb
    for i in range(b):
        rows = np.arange(i * p, i * p + p)
        args["x"][rows] = 3.0 * np.sign(args["q"][i])
        args["ids"][rows] = rows
        args["c_half"][i] = 3.0 * np.abs(args["q"][i]).sum()
    got = _check_walk(cuda, args, **_walk_kw(args, k, p, nb, progressive))
    assert got[4].all() and got[2].cpu().tolist() == [t + 1 for t in targets]


@pytest.mark.parametrize("d,p", [(300, 3), (5408, 1)])
def test_scan_blocks_kernel_wide_rows(cuda, d, p):
    for progressive in (False, True):
        rng = np.random.RandomState(d + int(progressive))
        args = _walk_inputs(rng, 90, p, d, 8, 10, progressive, True)
        _check_walk(cuda, args, **_walk_kw(args, 10, p, 90, progressive))


def test_scan_blocks_kernel_every_page_rows(cuda):
    """Every page_rows the launcher takes (1..256), each walk longer than
    two segments of 256 // page_rows steps."""
    for p in range(1, 257):
        nb = 2 * (256 // p) + 3
        for progressive in (False, True):
            rng = np.random.RandomState(p * 2 + int(progressive))
            args = _walk_inputs(rng, nb, p, 8, 3, 5, progressive, p % 2 == 0,
                                sel_frac=0.9)
            _check_walk(cuda, args, **_walk_kw(args, 5, p, nb, progressive))


def test_scan_blocks_kernel_carried_ties(cuda):
    """Every row a copy of one of four rows and a carried top-k of tied
    scores: entries that tie the k-th never enter, rows after ties."""
    rng = np.random.RandomState(23)
    for progressive in (False, True):
        args = _walk_inputs(rng, 120, 8, 16, 6, 12, progressive, True)
        base = args["x"][:4].copy()
        args["x"] = base[rng.randint(0, 4, args["x"].shape[0])]
        s = args["q"] @ args["x"].T
        for i in range(6):
            r = np.sort(rng.choice(np.nonzero(args["ids"] >= 0)[0], 12,
                                   replace=False))
            o = np.argsort(-s[i, r], kind="stable")
            args["init_scores"][i], args["init_rows"][i] = s[i, r][o], r[o]
        args["c_half"][:] = np.float32(1e9)
        _check_walk(cuda, args, **_walk_kw(args, 12, 8, 120, progressive))


def test_scan_blocks_kernel_back_to_back_on_one_scratch(cuda):
    """Two calls in a row reuse one freed scratch (same shapes): each equals
    its plain walk, and the first call again gives the same bits."""
    rng = np.random.RandomState(29)
    for progressive in (False, True):
        a1 = _walk_inputs(rng, 300, 8, 32, 16, 10, progressive, True)
        a2 = _walk_inputs(rng, 300, 8, 32, 16, 10, progressive, False)
        kw = _walk_kw(a1, 10, 8, 300, progressive)
        g1 = _check_walk(cuda, a1, **kw)
        _check_walk(cuda, a2, **kw)
        again = _check_walk(cuda, a1, **kw)
        for x, y in zip(g1, again):
            assert torch.equal(x, y)


@pytest.mark.parametrize("r,b,d,k", [(5000, 64, 128, 10), (4099, 7, 33, 128),
                                     (100, 4, 8, 120), (300, 3, 16, 290),
                                     (100, 5, 32, 129)])
def test_mips_topk_kernel_route_equals_plain(cuda, r, b, d, k):
    """`ops.mips_topk` on the card (block_mips for k <= 128, mips_score and a
    stable top-k above) against its plain route, on integer data: equal
    rows and scores; fewer valid rows than k leave -1 / -inf slots."""
    rng = np.random.RandomState(r + k)
    x = torch.from_numpy(rng.randint(-3, 4, (r, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.randint(-3, 4, (b, d)).astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.rand(r) > 0.1).to(cuda)
    before = dict(ops.LAUNCHES)
    got = ops.mips_topk(x, q, valid, k, use_kernels=True)
    name = "block_mips" if k <= ops.BLOCK_MIPS_MAX_K else "mips_score"
    assert ops.LAUNCHES[name] == before[name] + 1
    want = ops.mips_topk(x, q, valid, k, use_kernels=False)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    if k > int(valid.sum()):          # the slots past the valid rows
        if k <= ops.BLOCK_MIPS_MAX_K:
            assert bool(((got[1] == -1) & (got[0] == float("-inf"))).any())
        else:
            assert bool((got[0] == -1e30).any())


# -- the sharded search on padded shards --------------------------------------

SHARD_CASES = {
    "fused": dict(mode="two_phase", verification="fused", norm_adaptive=True,
                  cs_prune=True),
    "fused, prefilter": dict(mode="two_phase", verification="fused",
                             prefilter=True, prefilter_eps=0.3,
                             dense_frac=0.8),
    "batched, prefilter": dict(mode="two_phase", verification="batched",
                               prefilter=True, prefilter_eps=0.3),
    "progressive": dict(mode="progressive", cs_prune=True, budget=64),
}


@pytest.fixture(scope="module")
def padded_shards():
    """Three shards of 960, 960 and 961 integer-valued rows (every score
    exact in f32, whatever the summation order), where every padding rule of
    `build_sharded` applies: rows with id -1, zero-count groups (shards 0
    and 2), sub-partition centers at 1e30 (shards 0 and 1), a padded block
    and zero codewords (shards 0 and 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.core.sharded import build_sharded, device_put_sharded_index
    rng = np.random.RandomState(1)
    x = rng.randint(-3, 4, (2881, 32)).astype(np.float32)
    q = rng.randint(-3, 4, (16, 32)).astype(np.float32)
    sh = build_sharded(x, 3, m=8, c=0.9, p=0.7, norm_strata=4, seed=0)
    a = sh.arrays
    assert (a.g_count == 0).any() and (a.sp_center == np.float32(1e30)).any()
    assert (a.ids < 0).sum(axis=1).min() > 0
    return (device_put_sharded_index(sh, "cuda"),
            device_put_sharded_index(sh, "cpu"), torch.from_numpy(q))


@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_sharded_search_kernels_equal_plain_on_padded_shards(cuda,
                                                              padded_shards,
                                                              case):
    """`sharded_search` on the kernels, on the plain versions on the card
    and on the CPU: ids, scores and pages equal bit for bit (integer data:
    every score is exact, so only a frontend or sketch flip could move a
    result, and none does here)."""
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.core.sharded import sharded_search
    on_card, on_cpu, q = padded_shards
    cfg = RuntimeConfig(**SHARD_CASES[case])
    before = dict(ops.LAUNCHES)
    got = sharded_search(on_card, q.to(cuda), 10, device=cuda, runtime=cfg)
    torch.cuda.synchronize()
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
    plain = sharded_search(on_card, q.to(cuda), 10, device=cuda,
                           runtime=RuntimeConfig(use_kernels=False,
                                                 **SHARD_CASES[case]))
    cpu = sharded_search(on_cpu, q, 10, device="cpu", runtime=cfg)
    for name, want in (("plain on the card", plain), ("cpu", cpu)):
        assert torch.equal(got[0].cpu(), want[0].cpu()), f"{name}: ids"
        assert torch.equal(got[1].cpu(), want[1].cpu()), f"{name}: scores"
        assert int(got[2]) == int(want[2]), f"{name}: pages"
    kernel = "scan_blocks" if case == "progressive" else (
        "block_mips" if "fused" in case else "mips_score")
    assert launched[kernel] >= 3, launched
    if case != "progressive":
        assert launched["quick_probe_select"] == 3, launched


def test_sharded_padded_shard_kernels_equal_plain(cuda, padded_shards):
    """Each shard's view on the card: `quick_probe_select` (zero-count
    groups) gives the plain version's rows and Test-A flags, its radius
    within 1e-6 relative; `sketch_scores` (zero codewords) within
    1e-5 |q| |mu| + 1e-6 on the shard's real blocks (a padded block's codes
    point at codeword 0, not at its zero centroid: the prefilter drops it
    by its ids, in both packages)."""
    from repro_torch.core import search_device as sd
    from repro_torch.core.quick_probe import quick_probe_batch
    on_card, _, q = padded_shards
    q = q.to(cuda)
    meta = on_card.meta
    for s, arrays in enumerate(on_card.shards):
        table = sd._group_table(arrays)
        q_proj = q @ arrays.a
        q_l1 = q.abs().sum(dim=1)
        rk, r0k, ok_k = quick_probe_batch(table, q_proj, q_l1, meta.c,
                                          meta.x_p, True)
        rp, r0p, ok_p = quick_probe_batch(table, q_proj, q_l1, meta.c,
                                          meta.x_p, False)
        assert torch.equal(rk, rp) and torch.equal(ok_k, ok_p), s
        assert bool(((r0k - r0p).abs() <= 1e-6 * r0p.abs() + 1e-7).all()), s
        sk = (q, arrays.sk_mu, arrays.sk_codebooks, arrays.sk_codes)
        est_k = ops.sketch_scores(*sk, use_kernels=True)
        est_p = ops.sketch_scores(*sk, use_kernels=False)
        real = (arrays.ids.view(-1, meta.page_rows) >= 0).any(dim=1)
        tol = (1e-5 * q.norm(dim=1)[:, None] * arrays.sk_mu.norm(dim=1)[None, :]
               + 1e-6)
        assert bool(((est_k - est_p).abs() <= tol)[:, real].all()), s


def test_sharded_graphs_captured_once_per_shard(cuda, padded_shards):
    """Three fused sharded searches through one device index, with no
    graph held before them: each shard's stages run eagerly, then are
    captured, then replay; the third search captures nothing, and all three
    equal the per-shard host driver merged by the same rule, bit for bit."""
    from repro_torch.core import search_graph as sg
    from repro_torch.core.runtime import RuntimeConfig, _rescore
    from repro_torch.core.search_fused import search_batch_fused
    from repro_torch.core.sharded import sharded_search
    on_card, _, q = padded_shards
    q = q.to(cuda)
    cfg = RuntimeConfig(**SHARD_CASES["fused, prefilter"])
    nb = on_card.meta.n_blocks

    def n_graphs():
        return sum(len(e.graphs) for e in sg._GRAPHS.values()
                   if any(e.arrays is v for v in on_card.shards))

    sg.clear_graphs()     # earlier tests ran this key on these views
    runs, counts = [], []
    for _ in range(3):
        runs.append(sharded_search(on_card, q, 10, device=cuda, runtime=cfg))
        counts.append(n_graphs())
    assert counts[0] == 0 and counts[1] > 0 and counts[2] == counts[1], counts
    ids_all, s_all, pages = [], [], 0
    for arrays in on_card.shards:
        ids, _, st = search_batch_fused(
            arrays, on_card.meta, q, k=10, budget=nb, budget2=nb,
            prefilter=True, prefilter_eps=0.3, dense_frac=0.8)
        ids_all.append(ids)
        s_all.append(_rescore(arrays.x, st.rows, q))
        pages += int(st.pages.sum())
    best_s, pos = ref.topk_stable(torch.cat(s_all, dim=1), 10)
    best_i = torch.cat(ids_all, dim=1).gather(1, pos)
    for got in runs:
        assert torch.equal(got[0], best_i) and torch.equal(got[1], best_s)
        assert int(got[2]) == pages


def test_mutable_sharded_on_the_card_equals_the_cpu(cuda):
    """The streaming sharded index after churn and a compaction: the card
    (kernels, `mips_score` on each shard's delta) gives the CPU's ids,
    scores and stats on integer data."""
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.core.sharded import MutableShardedProMIPS
    rng = np.random.RandomState(2)
    x = rng.randint(-3, 4, (1500, 32)).astype(np.float32)
    q = rng.randint(-3, 4, (8, 32)).astype(np.float32)
    new = rng.randint(-3, 4, (60, 32)).astype(np.float32)
    cfg = RuntimeConfig(prefilter=True, prefilter_eps=0.3)
    kw = dict(m=8, c=0.9, p=0.7, norm_strata=4, seed=0, delta_capacity=128)
    card = MutableShardedProMIPS(x, 3, device=cuda, **kw)
    cpu = MutableShardedProMIPS(x, 3, device="cpu", **kw)
    for st in (card, cpu):
        st.insert(np.arange(1500, 1560), new)
        st.delete([2, 700, 1400, 1555])
        st.update([9, 1501], new[:2] * 2)
    before = ops.LAUNCHES["mips_score"]
    for step in ("churned", "compacted"):
        if step == "compacted":
            card.compact()
            cpu.compact()
        got = card.search(q, k=10, runtime=cfg)
        want = cpu.search(q, k=10, runtime=cfg)
        assert np.array_equal(got[0], want[0]), step
        assert np.array_equal(got[1], want[1]), step
        assert got[2] == want[2], step
    assert ops.LAUNCHES["mips_score"] - before == 3   # the churned search
