"""The decomposition of the `scan_blocks` kernel (`csrc/scan_blocks.cu`),
modelled step for step in torch on the CPU and held bit for bit against the
plain walk `ref.scan_blocks_ref` and against the JAX walk.

`walk_model` follows the kernel: each query's walk is cut into segments of
S steps (the kernel's 256 // page_rows; the tests vary S); a segment is
scored apart from the sequential chain, `lag` segments ahead of it, and
writes its rows' scores (-inf on padding rows) and one record a step.

Scan mode scores every step; a step's record is its valid rows >= c_half
and its valid rows, and the segment's summary its max valid score and the
sums of both. The chain counts over windows of up to `win` segments (the
kernel also cuts a window where its candidates would pass what it stages;
the tests vary `win`, and no window changes the result): a prefix sum of the segments' counts, from the carried entries >= c_half on,
finds the first segment at which it reaches k, a prefix sum of that
segment's step counts the stop step; the segments before it whose max
beats the running k-th score s_k, then the stop segment up to the stop
step, merge their rows in walk order.

Progressive mode scores the blocks that qualify under the k-th score the
chain had published when the segment was scored (the carried one when
`lag` is None); a step's record is its max valid score and valid rows, or
-1 if not scored. The chain replays windows of up to `win` segments: while
s_k holds it evaluates every pending step's liveness at once, counts the
live steps up to the first one whose max beats s_k, merges that step's rows
in row order and goes on from the next step.

Beside the plain walk, scan mode is held to the two invariants the kernel
rests on: the Condition-A stop is the first step at which the carried hits
plus the walked valid rows >= c_half reach k (a prefix count), and the
result is the top k of [carried, walked rows up to the stop] by score
descending (-0 as +0), then position ascending.

Inputs are integer-valued (exact scores, exact ties) with padding rows and
duplicate rows; the cases cover both modes, k 1 / 10 / 33, page_rows
1 / 3 / 8, an empty and a carried top-k, a score exactly at c_half, a stop
on a segment's first and on its last step, and S from 1 to past the walk.
The last test runs the port's scan and progressive searches with the model
in place of `ops.scan_blocks` against the jitted JAX searches.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search_device as jax_sd
from repro.core.index import build_index as jax_build_index
from repro_torch.convert import index_from_numpy
from repro_torch.core import search_device as sd
from repro_torch.core.index import IndexArrays
from repro_torch.data.synthetic import mf_factors
from repro_torch.kernels import ops, ref

TILE_ROWS = 256          # rows a segment scores (R in the kernel)
NEG_INF = float("-inf")


def walk_model(x, ids, q, order, init_s, init_r, c_half, *, k, page_rows,
               budget, n_sel=None, block_gap=None, block_max_l2sq=None,
               q_l2sq=None, c=1.0, x_p=0.0, cs_prune=False, seg=None,
               win=None, lag=0):
    """The kernel's walk; the arguments and results of `ref.scan_blocks_ref`
    plus the segment length ``seg`` (default the kernel's, 256 // page_rows),
    the window ``win`` in segments (default the kernel's: scan 32 segments,
    progressive at most 32 segments and 1,024 steps) and the scoring
    ``lag``."""
    pr = page_rows
    prog = block_gap is not None
    S = seg or max(1, TILE_ROWS // pr)
    win = win or (min(32, max(1, 1024 // S)) if prog else 32)
    b, nb = order.shape
    scores = (x.float() @ q.float().T).T                        # (B, n_pad)
    valid = ids >= 0
    out_s, out_r = init_s.float().clone(), init_r.int().clone()
    pages = torch.zeros(b, dtype=torch.int32)
    cand = torch.zeros(b, dtype=torch.int32)
    done = torch.zeros(b, dtype=torch.bool)
    for i in range(b):
        ts, tr = out_s[i].tolist(), out_r[i].tolist()
        ch = float(c_half[i])
        if ts[k - 1] >= ch:
            done[i] = True
            continue
        lim = min(budget, nb) if prog else min(budget, nb, int(n_sel[i]))
        nseg = -(-max(lim, 0) // S)
        rec = {}            # step -> (smax, vc) or, in scan mode, (hits, vc)
        rows = {}                                  # step -> row scores
        segs = {}           # scan: segment -> (smax, hits, vc)
        st = dict(s_k=ts[k - 1], pages=0, cand=0, done=False, t=0, s=0,
                  cnt=sum(e >= ch for e in ts))
        quals = {}

        def qual(s_k):
            """Each step's qualify under s_k (the kernel's per-step test)."""
            if s_k not in quals:
                blk = order[i].long()
                quals[s_k] = ref.scan_qualify(
                    block_gap[i, blk], block_max_l2sq[blk],
                    torch.tensor(s_k, dtype=torch.float32), q_l2sq[i], c, x_p,
                    cs_prune).tolist()
            return quals[s_k]

        def score_segment(s, bound):
            for t in range(s * S, min((s + 1) * S, lim)):
                blk = int(order[i, t])
                if prog and not qual(bound)[t]:
                    rec[t] = (NEG_INF, -1)
                    continue
                r = slice(blk * pr, (blk + 1) * pr)
                v = valid[r]
                sv = torch.where(v, scores[i, r], torch.full((pr,), NEG_INF))
                rows[t] = sv.tolist()
                smax = float(sv.max()) if bool(v.any()) else NEG_INF
                hits = int((v & (scores[i, r] >= ch)).sum())
                rec[t] = (smax, int(v.sum())) if prog else (hits, int(v.sum()))
            if not prog:
                steps = range(s * S, min((s + 1) * S, lim))
                segs[s] = (max([max(rows[t]) for t in steps]),
                           sum(rec[t][0] for t in steps),
                           sum(rec[t][1] for t in steps))

        def merge(t0, t1):
            """Merge the rows of steps [t0, t1) in walk order."""
            for t in range(t0, t1):
                blk = int(order[i, t])
                for r, sv in enumerate(rows[t]):
                    if sv > ts[k - 1]:
                        pos = sum(e >= sv for e in ts)
                        ts.insert(pos, sv)
                        tr.insert(pos, blk * pr + r)
                        del ts[k:], tr[k:]

        def count(s1):
            """Scan mode: carry the chain over the scored segments
            [st.s, s1), window by window."""
            while st["s"] < s1 and not st["done"]:
                w = range(st["s"], min(s1, st["s"] + win))
                incl = np.cumsum([segs[g][1] for g in w])
                reach = [j for j, h in enumerate(incl) if st["cnt"] + h >= k]
                fs = reach[0] if reach else len(w)
                for g in w[:fs]:
                    t0, t1 = g * S, min((g + 1) * S, lim)
                    st["pages"] += t1 - t0
                    st["cand"] += segs[g][2]
                    if segs[g][0] > ts[k - 1]:
                        merge(t0, t1)
                if reach:
                    g = w[fs]
                    before = st["cnt"] + int(incl[fs]) - segs[g][1]
                    t = g * S
                    while before + rec[t][0] < k:
                        before += rec[t][0]
                        st["cand"] += rec[t][1]
                        t += 1
                    st["cand"] += rec[t][1]
                    st["pages"] += t + 1 - g * S
                    merge(g * S, t + 1)
                    st["done"] = True
                    assert ts[k - 1] >= ch
                    break
                st["cnt"] += int(incl[-1])
                st["s"] = w[-1] + 1

        def replay(t1):
            """Replay the scored steps [st.t, t1) window by window."""
            while st["t"] < t1 and not st["done"]:
                w0 = st["t"]
                w1 = min(t1, (w0 // S + win) * S)
                pend = [t for t in range(w0, w1) if rec[t][1] >= 0]
                while True:
                    ok = qual(st["s_k"]) if prog else None
                    live = [t for t in pend if not prog or ok[t]]
                    beat = [t for t in live if rec[t][0] > st["s_k"]]
                    f = beat[0] if beat else None
                    for t in live:
                        if f is None or t <= f:
                            st["pages"] += 1
                            st["cand"] += rec[t][1]
                    if f is None:
                        break
                    merge(f, f + 1)
                    st["s_k"] = ts[k - 1]
                    pend = [t for t in pend if t > f]
                    if st["s_k"] >= ch:
                        st["done"] = True
                        break
                st["t"] = w1

        chain = replay if prog else (lambda t1: count(-(-t1 // S)))
        for s in range(nseg):
            if lag is not None:
                chain(max(0, s - lag) * S)
            if st["done"]:
                break                        # the later segments are skipped
            score_segment(s, st["s_k"] if lag is not None else ts[k - 1])
        chain(lim)        # a step left unscored would be missed here
        out_s[i] = torch.tensor(ts, dtype=torch.float32)
        out_r[i] = torch.tensor(tr, dtype=torch.int32)
        pages[i], cand[i], done[i] = st["pages"], st["cand"], st["done"]
    return out_s, out_r, pages, cand, done


def _inputs(rng, nb, pr, d, b, k, progressive, carried, stop_q=0.995,
            sel_frac=0.6):
    """Integer-valued walk inputs (exact scores and ties): padding rows,
    duplicate rows, c_half at the ``stop_q`` quantile of each query's
    scores; scan mode a random selection, its order and n_sel; progressive
    mode gaps about the radii of the running k-th score."""
    n = nb * pr
    x = rng.randint(-3, 4, (n, d)).astype(np.float32)
    dup = rng.choice(n, n // 6, replace=False)
    x[dup] = x[rng.choice(n, len(dup))]
    ids = np.where(rng.rand(n) > 0.15, np.arange(n), -1).astype(np.int32)
    q = rng.randint(-3, 4, (b, d)).astype(np.float32)
    s = q @ x.T
    c_half = np.quantile(s, stop_q, axis=1).astype(np.float32)
    init_s = np.full((b, k), -np.inf, np.float32)
    init_r = np.full((b, k), -1, np.int32)
    if carried:
        live = np.nonzero(ids >= 0)[0]
        for i in range(b):
            m = min(k, len(live) // 2)
            m = m if i % 3 else max(1, m // 2)              # some tails empty
            rows = np.sort(rng.choice(live, m, replace=False))
            sc = s[i, rows]
            o = np.argsort(-sc, kind="stable")
            init_s[i, :m], init_r[i, :m] = sc[o], rows[o]
    args = dict(x=x, ids=ids, q=q, init_s=init_s, init_r=init_r, c_half=c_half)
    kw = dict(k=k, page_rows=pr, budget=nb)
    if progressive:
        gap = rng.uniform(0, 40, (b, nb)).astype(np.float32)
        args["order"] = np.argsort(gap, axis=1, kind="stable").astype(np.int32)
        kw.update(block_gap=gap,
                  block_max_l2sq=rng.uniform(0, 8 * d, nb).astype(np.float32),
                  q_l2sq=(q * q).sum(1).astype(np.float32), c=0.9, x_p=7.0,
                  cs_prune=True)
    else:
        mask = rng.rand(b, nb) < sel_frac
        args["order"] = np.argsort(~mask, axis=1, kind="stable").astype(np.int32)
        kw["n_sel"] = mask.sum(1).astype(np.int32)
    return args, kw


def _torch(args, kw):
    t = {n: torch.from_numpy(v) for n, v in args.items()}
    pos = [t[n] for n in ("x", "ids", "q", "order", "init_s", "init_r",
                          "c_half")]
    kw = {n: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for n, v in kw.items()}
    return pos, kw


def _assert_equal(got, want):
    for name, g, w in zip(("top_s", "top_r", "pages", "cand", "done"), got,
                          want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


def _assert_scan_invariants(pos, kw, got):
    """Scan mode: the stop is the prefix count's, the top-k the key order's."""
    x, ids, q, order, init_s, init_r, c_half = pos
    k, pr = kw["k"], kw["page_rows"]
    scores = (x @ q.T).T
    for i in range(q.shape[0]):
        n0 = int((init_s[i] >= c_half[i]).sum())
        if init_s[i, k - 1] >= c_half[i]:
            assert bool(got[4][i]) and int(got[2][i]) == 0
            continue
        lim = min(kw["budget"], order.shape[1], int(kw["n_sel"][i]))
        rows = [torch.arange(int(order[i, t]) * pr, (int(order[i, t]) + 1) * pr)
                for t in range(lim)]
        hits = [int(((scores[i, r] >= c_half[i]) & (ids[r] >= 0)).sum())
                for r in rows]
        reach = [t for t in range(lim) if n0 + sum(hits[:t + 1]) >= k]
        stop = reach[0] if reach else None
        assert bool(got[4][i]) == (stop is not None)
        assert int(got[2][i]) == (stop + 1 if reach else lim)
        walked = torch.cat(rows[:int(got[2][i])] + [torch.zeros(0, dtype=torch.long)])
        walked = walked[ids[walked] >= 0]
        pool_s = torch.cat([init_s[i], scores[i, walked]])
        pool_r = torch.cat([init_r[i], walked.int()])
        key = torch.where(pool_s == 0, torch.zeros_like(pool_s), pool_s)
        o = torch.sort(key, descending=True, stable=True).indices[:k]
        np.testing.assert_array_equal(got[0][i].numpy(), pool_s[o].numpy())
        np.testing.assert_array_equal(got[1][i].numpy(), pool_r[o].numpy())


@pytest.mark.parametrize("carried", [False, True], ids=["empty", "carried"])
@pytest.mark.parametrize("pr", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 10, 33])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["scan", "progressive"])
def test_model_equals_plain_walk(progressive, k, pr, carried):
    rng = np.random.RandomState(100 * k + 10 * pr + int(progressive))
    nb = {1: 240, 3: 90, 8: 70}[pr]
    args, kw = _inputs(rng, nb, pr, 12, 4, k, progressive, carried)
    pos, kw = _torch(args, kw)
    want = ref.scan_blocks_ref(*pos, **kw)
    seg = max(1, TILE_ROWS // pr)
    for s in sorted({1, 7, seg // 4 or 1, seg}):
        for lag in ((0, 3, None) if progressive else (0,)):
            _assert_equal(walk_model(*pos, **kw, seg=s, lag=lag), want)
    if not progressive:
        _assert_scan_invariants(pos, kw, want)
    if carried:
        assert int(want[2].sum()) > 0


def _stop_step(want, i):
    return int(want[2][i]) - 1 if bool(want[4][i]) else None


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["scan", "progressive"])
def test_stop_on_a_segment_boundary_and_at_c_half(progressive):
    """c_half set to a walked row's exact score, so Condition A stops on
    that row; S chosen so the stop step is a segment's first and its last
    step, and from 1 to past the walk's length."""
    rng = np.random.RandomState(7 + int(progressive))
    k, pr, nb = 4, 2, 80
    args, kw = _inputs(rng, nb, pr, 10, 3, k, progressive, False,
                       stop_q=1.0, sel_frac=0.9)
    pos, kw = _torch(args, kw)
    x, ids, q, order = pos[:4]
    scores = (x @ q.T).T
    for i in range(q.shape[0]):         # the (k+2)-th valid row walked
        t, seen = 0, []
        while len(seen) < k + 2:
            blk = int(order[i, t])
            seen += [float(scores[i, r]) for r in range(blk * pr, blk * pr + pr)
                     if ids[r] >= 0]
            t += 1
        pos[6][i] = sorted(seen, reverse=True)[k - 1]
    want = ref.scan_blocks_ref(*pos, **kw)
    stops = [_stop_step(want, i) for i in range(q.shape[0])]
    assert all(s is not None for s in stops), stops
    exact = [bool((scores[i][ids >= 0] == pos[6][i]).any())
             for i in range(q.shape[0])]
    assert all(exact)
    lim = int(want[2].max())
    segs = {1, 2, 3, lim, lim + 5, nb + 3}
    for s in stops:
        segs |= {s, s + 1} - {0}            # stop on a first / a last step
    for s in sorted(segs):
        for win in (1, 3):
            _assert_equal(walk_model(*pos, **kw, seg=s, win=win, lag=1), want)
    if not progressive:
        _assert_scan_invariants(pos, kw, want)


def test_model_equals_plain_walk_with_ties_and_a_budget():
    """Every row a copy of four rows (ties everywhere), a budget that
    truncates, a carried top-k of tied scores."""
    rng = np.random.RandomState(3)
    for progressive in (False, True):
        args, kw = _inputs(rng, 60, 3, 8, 3, 10, progressive, True)
        base = args["x"][:4].copy()
        args["x"] = base[rng.randint(0, 4, args["x"].shape[0])]
        s = args["q"] @ args["x"].T
        for i in range(3):
            r = np.sort(rng.choice(np.nonzero(args["ids"] >= 0)[0], 10,
                                   replace=False))
            o = np.argsort(-s[i, r], kind="stable")
            args["init_s"][i], args["init_r"][i] = s[i, r][o], r[o]
        args["c_half"][:] = np.float32(1e9)
        kw["budget"] = 23
        pos, kw = _torch(args, kw)
        want = ref.scan_blocks_ref(*pos, **kw)
        for seg in (1, 4, 85):
            _assert_equal(walk_model(*pos, **kw, seg=seg, lag=2), want)


@pytest.fixture(scope="module")
def small_index():
    x = mf_factors(4000, 32, 8, decay=0.5, norm_tail=0.6, seed=0)
    q = mf_factors(12, 32, 8, decay=0.5, seed=1)
    built = jax_build_index(x, m=8, c=0.9, p=0.6, k_p=5, k_sp=8,
                            norm_strata=4, seed=0)
    host = {f: np.asarray(getattr(built.arrays, f)) for f in IndexArrays._fields}
    arrays, meta = index_from_numpy(host, dataclasses.asdict(built.meta),
                                    device="cpu")
    return dict(q=q, meta=meta, arrays=arrays, jmeta=built.meta,
                jarrays=jax.tree.map(jnp.asarray, built.arrays))


def test_model_in_the_searches_equals_the_jax_walk(small_index, monkeypatch):
    """The port's scan and progressive searches with the model walking in
    place of `ops.scan_blocks` (short segments, a lagging bound) give the
    jitted JAX searches' ids, rows, pages and candidates."""
    idx = small_index
    calls = []

    def model(*a, use_kernels=None, **kw):
        calls.append(kw["page_rows"])
        return walk_model(*a, **kw, seg=5, win=2, lag=2)

    monkeypatch.setattr(ops, "scan_blocks", model)
    q = idx["q"]
    budget = idx["meta"].n_blocks
    got = sd.search_batch(idx["arrays"], idx["meta"], torch.from_numpy(q),
                          k=10, budget=budget, budget2=budget,
                          verification="scan", prefilter=True,
                          prefilter_eps=0.5)
    want = jax_sd.search_batch(idx["jarrays"], idx["jmeta"], jnp.asarray(q),
                               k=10, budget=budget, budget2=budget,
                               verification="scan", prefilter=True,
                               prefilter_eps=0.5)
    pg = sd.search_batch_progressive(idx["arrays"], idx["meta"],
                                     torch.from_numpy(q), k=10, budget=budget,
                                     cs_prune=True)
    pw = jax_sd.search_batch_progressive(idx["jarrays"], idx["jmeta"],
                                         jnp.asarray(q), k=10, budget=budget,
                                         cs_prune=True)
    assert len(calls) == 3                  # two scan rounds, one walk
    for (ids, scores, st), (jids, jscores, jst) in ((got, want), (pg, pw)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        for name in ("rows", "pages", "candidates", "exhausted"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(jst, name)),
                                          err_msg=name)
        js = np.asarray(jscores)
        assert np.allclose(scores.numpy(), js, rtol=1e-5, atol=1e-6)
    assert math.isfinite(float(pg[1].min()))
