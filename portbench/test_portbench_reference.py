"""The plain reference: exact top-k, the readings `compare` gives on a
small corpus, and the TF32 rounding of the control."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference import exact_mips


@pytest.fixture
def small():
    rng = np.random.RandomState(3)
    x = rng.standard_normal((500, 16)).astype(np.float32)
    q = rng.standard_normal((40, 16)).astype(np.float32)
    s = q.astype(np.float64) @ x.T.astype(np.float64)
    ids = np.argsort(-s, axis=1)[:, :5]
    return x, q, ids, np.take_along_axis(s, ids, 1)


def test_exact_topk_matches_a_sort(small):
    x, q, ids, scores = small
    got_i, got_s = exact_mips.exact_topk(torch.from_numpy(x),
                                         torch.from_numpy(q), 5)
    assert np.array_equal(got_i.numpy(), ids)
    np.testing.assert_allclose(got_s.numpy(), scores, rtol=1e-5, atol=1e-5)


def test_exact_answers_read_exact(small):
    x, q, ids, scores = small
    r = exact_mips.compare(x, q, ids, scores.astype(np.float32), c=0.9,
                           device="cpu")
    assert r["invalid"] == 0 and r["recall"] == 1.0
    assert r["guarantee_share"] == 1.0 and r["queries"] == 40
    assert r["score_gap"] < 1e-6


def test_recall_counts_the_exact_top_k_returned(small):
    x, q, ids, scores = small
    worse = ids.copy()
    worse[:10, 4] = np.argsort(-(q[:10] @ x.T), axis=1)[:, 20]   # rank 21
    s = np.einsum("nkd,nd->nk", x[worse].astype(np.float64), q)
    r = exact_mips.compare(x, q, worse, s, c=0.9, device="cpu")
    assert r["recall"] == pytest.approx(1.0 - 10 / (40 * 5))
    assert r["score_gap"] < 1e-6 and r["invalid"] == 0


def test_invalid_entries_are_counted(small):
    x, q, ids, scores = small
    bad = ids.copy()
    bad[0, 0] = 500                 # outside the corpus
    bad[1, 1] = bad[1, 0]           # twice in one list
    sc = scores.copy()
    sc[2, 0] = np.nan
    r = exact_mips.compare(x, q, bad, sc, c=0.9, device="cpu")
    assert r["invalid"] == 3


def test_a_wrong_score_shows_as_a_gap(small):
    x, q, ids, scores = small
    sc = scores.copy()
    sc[5, 2] *= 1.001
    r = exact_mips.compare(x, q, ids, sc, c=0.9, device="cpu")
    assert r["score_gap"] > 1e-5


def test_tf32_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -(1.0 + 2**-12), 3.0])
    got = exact_mips.to_tf32(t)
    want = torch.tensor([1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0, 3.0])
    assert torch.equal(got, want)


def test_a_changing_catalog_is_judged_by_its_live_rows(small):
    """Rows 500.. are new; a query sees the rows live at its step, and an
    id deleted or not yet inserted is no answer."""
    from portbench import traffic
    x, q, _, _ = small
    rng = np.random.RandomState(4)
    new = rng.standard_normal((10, 16)).astype(np.float32)
    born = np.r_[np.full(500, -1), np.full(10, 3)].astype(np.int64)
    died = np.full(510, traffic.NEVER, np.int64)
    allx = np.concatenate([x, new])
    s = q.astype(np.float64) @ allx.T.astype(np.float64)
    died[np.argmax(s[0])] = 2           # query 0's best row, gone at step 2
    w = traffic.Writes(n=500, rows=new, prefill=0,
                       pre_deleted=np.zeros(0, np.int64), inserts=10,
                       deletes=np.zeros((4, 0), np.int64), born=born,
                       died=died)
    steps = np.r_[np.full(20, 1), np.full(20, 3)]
    live = np.stack([w.live(t) for t in steps])
    ids = np.argsort(-np.where(live, s, -np.inf), axis=1)[:, :5]
    sc = np.take_along_axis(s, ids, 1)
    r = exact_mips.compare(x, q, ids, sc, c=0.9, device="cpu", writes=w,
                           steps=steps)
    assert r["invalid"] == 0 and r["recall"] == 1.0
    gone = np.argmax(s[0])
    assert ids[0, 0] == gone            # live at step 1: an answer
    stale = ids.copy()
    stale[20, 0] = gone                 # deleted at step 2: no answer at 3
    stale[1, 0] = 505                   # inserted at step 3: none at 1
    r = exact_mips.compare(x, q, stale, sc, c=0.9, device="cpu", writes=w,
                           steps=steps)
    assert r["invalid"] == 2


def test_the_control_takes_writes():
    rng = np.random.RandomState(5)
    x = rng.standard_normal((100, 8)).astype(np.float32)
    ctl = exact_mips.ControlSearch(x, 3, "cpu")
    new = 10 * np.ones((1, 8), np.float32)
    ctl.insert([100], new)
    ids, _, _ = ctl(np.ones((2, 8), np.float32))
    assert (ids[:, 0] == 100).all()
    ctl.delete([100])
    ids, _, _ = ctl(np.ones((2, 8), np.float32))
    assert 100 not in ids
    with pytest.raises(ValueError, match="next ids"):
        ctl.insert([205], new)
