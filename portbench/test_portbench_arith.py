"""The window's arithmetic (rate, tail, the check's sample), the seeds, and
the frozen kernel counts against values worked out by hand."""
from __future__ import annotations

import statistics

import numpy as np
import pytest

from portbench import corpus, roofline_counts as rc, traffic
from portbench.metrics import batch_ms_p95, queries_per_s, pages_per_query


class _Ctx:
    def __init__(self, win, pages=()):
        self.window, self.pages = win, list(pages)


def _window(latencies, batch=64):
    win = traffic.Window(batch=batch)
    win.latencies_s = list(latencies)
    win.t_start, win.t_end = 100.0, 100.0 + sum(latencies)
    return win


def test_rate_and_tail_over_every_batch():
    lat = [0.004] * 95 + [0.010] * 5         # 100 batches, 5 slow ones
    win = _window(lat)
    assert queries_per_s.read(_Ctx(win)) == pytest.approx(
        6400 / (95 * 0.004 + 5 * 0.010))
    # numpy's linear percentile: rank 0.95 * 99 = 94.05 between 4 and 10 ms
    assert batch_ms_p95.read(_Ctx(win)) == pytest.approx(4.0 + 0.05 * 6.0)
    assert traffic.rate_by_part(win, 4)[:3] == pytest.approx([16000.0] * 3)
    assert traffic.rate_by_part(win, 4)[3] == pytest.approx(
        64 * 25 / (20 * 0.004 + 5 * 0.010))


def test_empty_window_reads_nothing():
    win = _window([])
    assert queries_per_s.read(_Ctx(win)) is None
    assert batch_ms_p95.read(_Ctx(win)) is None
    assert pages_per_query.read(_Ctx(win)) is None


def test_pages_per_query_over_the_window():
    win = _window([0.005, 0.005], batch=4)
    assert pages_per_query.read(_Ctx(win, [(40, 12), (20, 9)])) == 60 / 8


def test_closed_loop_sends_each_batch_once_and_stops_after_deadline():
    pool = np.arange(5 * 2 * 3, dtype=np.float32).reshape(5, 2, 3)
    sent = []

    def search(q):
        sent.append(int(q[0, 0]))
        return np.zeros((2, 1), np.int64), np.zeros((2, 1)), 0

    win = traffic.closed_loop(search, pool, 0.0)
    assert win.n_batches == 1 and sent == [0] and not win.wrapped
    win = traffic.closed_loop(lambda q: 1 / 0, pool, 10.0)
    assert win.failed_batches == 1 and win.n_batches == 0
    assert "ZeroDivisionError" in win.error


def test_check_sample_is_drawn_from_the_seed():
    win = _window([0.001] * 50)
    a = traffic.check_sample(win, 8, 2**31 + 5)
    assert len(a) == 8 and len(set(a)) == 8 and a.max() < 50
    assert np.array_equal(a, traffic.check_sample(win, 8, 2**31 + 5))
    assert np.array_equal(traffic.check_sample(win, 80, 1), np.arange(50))


def test_seeds_beyond_32_bits_give_distinct_streams():
    s = [corpus.derive(seed, "corpus") for seed in (2**31 + 1, 2**33 + 1, 1)]
    assert len(set(s)) == 3 and all(0 <= v < 2**32 for v in s)
    assert corpus.derive(7, "corpus") != corpus.derive(7, "queries")


def test_spread_is_the_quartile_distance_over_the_median():
    # how PERF.md's spreads are read: Python's quartiles, not numpy's
    q1, _, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert (q1, q3) == (1.75, 5.25)


def test_block_mips_count_by_hand():
    # b 2, d 4, k 3, 2 rows a page, 5 slots, 3 pages read, 4 pairs
    got = rc.block_mips(2, 4, 3, 2, 5, 3, 4)
    nbytes = (3 * 2 * (4 * 4 + 1) + 2 * 4 * 4 + 5 * 4 + 2 * 5
              + 2 * 2 * 3 * 8 + 2 * 4 + 2 * 5 * 4 + 2 * 8)
    assert got["bytes"] == nbytes == 324
    assert got["flops"] == 2 * 4 * 2 * 4 == 64
    assert got["roofline_s"] == pytest.approx(324 / rc.HBM_BW)
    assert got["bound"] == "memory"


def test_sketch_scores_count_by_hand():
    got = rc.sketch_scores(64, 128, 1000, 16, 256, 8)
    assert got["bytes"] == 1000 * 16 * 4 + 16 * 256 * 8 * 4 + 64 * 128 * 4 \
        + 64 * 1000 * 4
    assert got["flops"] == 2 * 64 * 16 * 256 * 8 + 64 * 1000 * 16


def test_mips_score_and_quick_probe_counts_by_hand():
    got = rc.mips_score(1000, 64, 128)
    assert got["flops"] == 2 * 1000 * 64 * 128
    assert got["bytes"] == 1000 * 128 * 4 + 64 * 128 * 4 + 1000 + 1000 * 64 * 4
    got = rc.quick_probe_select(64, 100, 16)
    assert got["flops"] == 64 * 100 * (2 * 16 + 10)
    assert got["bytes"] == 100 * 16 + 2 * 64 * (16 * 4 + 4) + 64 * 9


def test_compute_bound_when_flops_dominate():
    got = rc.cost(rc.PEAK_FP32, 1.0)
    assert got["bound"] == "compute" and got["roofline_s"] == 1.0


def _writes(seed=2**31 + 9, steps=50):
    cfg = {"n": 200, "d": 8, "corpus": {"recipe": "mf_factors",
                                       "data_seed": 0, "rank": 4,
                                       "decay": 0.5, "norm_tail": 0.6}}
    mix = {"writes": {"prefill_rows": 20, "pre_delete_base": 9,
                      "insert_rows": 4, "delete_base": 2,
                      "delete_delta": 2}}
    return traffic.make_writes(cfg, mix, seed, steps)


def test_writes_schedule_keeps_its_counts_and_its_seed():
    w = _writes()
    assert w.rows.shape == (20 + 4 * 50, 8) and w.n_steps == 50
    assert (w.died[w.pre_deleted] == -1).all()
    for t in (0, 17, 49):
        live = w.live(t)
        # the corpus loses its pre-deleted rows and two a step
        assert (~live[:200]).sum() == 9 + 2 * (t + 1)
        assert w.new_live(t) == 20 + (4 - 2) * (t + 1)
        ids, _ = w.step_inserts(t)
        assert ids.tolist() == list(range(220 + 4 * t, 224 + 4 * t))
        assert (w.born[ids] == t).all()
        gone = w.deletes[t]
        assert (w.died[gone] == t).all() and live[gone].sum() == 0
        # live until that step, or inserted in it
        assert (w.live(t - 1)[gone] | (w.born[gone] == t)).all()
        assert (gone[:2] < 200).all() and (gone[2:] >= 200).all()
    assert len(np.unique(w.deletes)) == w.deletes.size
    same = _writes()
    assert np.array_equal(w.deletes, same.deletes)
    assert np.array_equal(w.rows, same.rows)
    assert not np.array_equal(w.deletes, _writes(seed=3).deletes)


def test_new_rows_follow_the_corpus_recipe():
    cfg = {"n": 4000, "d": 16, "corpus": {"recipe": "mf_factors",
                                         "data_seed": 0, "rank": 4,
                                         "decay": 0.5, "norm_tail": 0.0}}
    x = corpus.mf_factors(4000, 16, 4, decay=0.5, seed=0)
    new = corpus.new_rows(cfg, 500, 11)
    # the same rank-4 latent space: the corpus's basis spans the new rows
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    resid = new - (new @ vt[:4].T) @ vt[:4]
    assert np.abs(resid).max() < 1e-3 * np.abs(new).max()
    assert not np.array_equal(new, corpus.new_rows(cfg, 500, 12))


def test_step_readers_over_the_writes_and_the_trace():
    from portbench.metrics import mips_score_roofline, snapshot_ms_per_step

    class _Trace:
        def port_s(self, wrapper):
            return {"mips_score": 2e-3}.get(wrapper)

    w = _writes()
    ctx = _Ctx(_window([0.01] * 6, batch=64))
    ctx.trace, ctx.writes, ctx.meta = _Trace(), w, {"d": 8}
    ctx.first_step, ctx.stretch = 10, (2, 5)
    ctx.snapshot_s = [0.004, 0.006]
    least = sum(rc.mips_score(20 + 2 * (t + 1), 64, 8)["roofline_s"]
                for t in (12, 13, 14))
    assert mips_score_roofline.read(ctx) == pytest.approx(
        100 * least / 2e-3)
    assert snapshot_ms_per_step.read(ctx) == pytest.approx(5.0)
    ctx.writes, ctx.snapshot_s = None, []
    assert mips_score_roofline.read(ctx) is None
    assert snapshot_ms_per_step.read(ctx) is None
