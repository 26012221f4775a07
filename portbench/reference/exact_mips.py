"""Exact maximum inner product search in plain PyTorch: the reference of the
ProMIPS configurations, and the comparison that decides `correct`.

The reference reads only the corpus and the queries the benchmark made. It
runs in float32 with TF32 off for the exact top-k, and in float64 for the
true scores of the ids the program returned. The numbers it compares:

  invalid         returned entries that are no answer: an id outside the
                  corpus, an id not live when the query was searched
                  (deleted, or not yet inserted), an id twice in one
                  query's list, a score that is not finite (limit 0)
  score_gap       the largest |returned score - true score of that id|,
                  each over |q| |x_id|, the scale of a float32 dot product's
                  rounding
  recall          the mean share of each query's exact top k that the
                  program returned
  guarantee_share the share of queries whose returned items, ranked by true
                  score, each reach c times the exact item of that rank
                  (ranks whose exact score is not positive hold vacuously):
                  the paper's Theorem 2, which promises it with probability
                  p

Where the catalog changes while it is queried, the reference follows the
mix's own schedule of writes (`traffic.Writes`): each query is searched over
the rows live at its step, from the corpus and the new rows the benchmark
made.

`ControlSearch` is the reference put in the program's place at the next
precision below the configuration's float32 with TF32 off: each operand
rounded to TF32 (10 mantissa bits, round to nearest even), products summed
in float32, as the tensor cores' TF32 mode computes.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK = 512          # queries a block of the exact top-k


class _NoTF32:
    """Float32 matrix products in float32, whatever the process set."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def exact_topk(x: torch.Tensor, q: torch.Tensor, k: int,
               live: torch.Tensor = None):
    """The exact top ``k`` of every query over the rows of ``x`` (those
    where ``live`` holds, if given): (ids int64, scores float32), each
    (N, k), in blocks of `BLOCK` queries."""
    ids, scores = [], []
    with _NoTF32():
        for i in range(0, q.shape[0], BLOCK):
            s = q[i:i + BLOCK] @ x.T
            if live is not None:
                s.masked_fill_(~live, float("-inf"))
            top = torch.topk(s, k, dim=1)
            ids.append(top.indices)
            scores.append(top.values)
    return torch.cat(ids), torch.cat(scores)


def true_scores(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor):
    """float64 <q, x[id]> for each returned id (ids clamped into range; the
    caller masks the invalid ones) and the scale |q| |x_id|."""
    rows = x[ids.clamp(0, x.shape[0] - 1)].double()          # (N, k, d)
    qd = q.double()
    s = torch.einsum("nkd,nd->nk", rows, qd)
    scale = rows.norm(dim=2) * qd.norm(dim=1, keepdim=True)
    return s, scale


def _blocks(steps, n: int):
    """[start, end) runs of at most `BLOCK` queries that share a step."""
    if steps is None:
        return [(i, min(n, i + BLOCK)) for i in range(0, n, BLOCK)]
    cuts = [0] + [i for i in range(1, n) if steps[i] != steps[i - 1]] + [n]
    return [(i, min(e, i + BLOCK)) for s, e in zip(cuts, cuts[1:])
            for i in range(s, e, BLOCK)]


def compare(x: np.ndarray, queries: np.ndarray, ids: np.ndarray,
            scores: np.ndarray, *, c: float, device, writes=None,
            steps=None) -> dict:
    """The readings of one run's checked answers. ``queries`` (N, d),
    ``ids`` and ``scores`` (N, k) as the program returned them. With
    ``writes`` (`traffic.Writes`), ``x`` is the corpus and query i was
    searched at step ``steps[i]``."""
    if writes is not None:
        x = np.concatenate([x, writes.rows])
        born = torch.from_numpy(writes.born).to(device)
        died = torch.from_numpy(writes.died).to(device)
    n, k = x.shape[0], ids.shape[1]
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    invalid = 0
    gap = 0.0
    hits = 0
    met = 0
    for i, e in _blocks(None if writes is None else steps, len(queries)):
        q = torch.from_numpy(np.ascontiguousarray(queries[i:e])).to(device)
        got = torch.from_numpy(np.asarray(ids[i:e], np.int64)).to(device)
        s_got = torch.from_numpy(np.asarray(scores[i:e], np.float64)).to(
            device)
        live = None
        if writes is not None:
            live = (born <= int(steps[i])) & (died > int(steps[i]))
        ex_ids, ex_s = exact_topk(xt, q, k, live)
        in_range = (got >= 0) & (got < n)
        if live is not None:
            in_range &= live[got.clamp(0, n - 1)]
        srt = torch.sort(torch.where(in_range, got, -1 - torch.arange(
            k, device=device)), dim=1).values
        dup = torch.zeros_like(in_range)
        dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
        bad = ~in_range | ~torch.isfinite(s_got)
        invalid += int(bad.sum()) + int(dup.sum())
        true, scale = true_scores(xt, q, got)
        ok = ~bad
        rel = (s_got - true).abs() / scale.clamp_min(1e-30)
        if bool(ok.any()):
            gap = max(gap, float(rel[ok].max()))
        hits += int((got[:, :, None] == ex_ids[:, None, :]).any(2).sum())
        ranked = torch.sort(torch.where(ok, true, float("-inf")), dim=1,
                            descending=True).values
        exd = ex_s.double()
        each = (ranked >= c * exd - 1e-6 * exd.abs()) | (exd <= 0.0)
        met += int(each.all(dim=1).sum())
    nq = len(queries)
    return {"invalid": invalid, "score_gap": gap, "recall": hits / (nq * k),
            "guarantee_share": met / nq, "queries": nq}


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, nearest even)."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


class ControlSearch:
    """The reference in the program's place in TF32: exact top-k over the
    TF32-rounded rows and queries, summed in float32. It takes the writes
    of a changing catalog: new rows under the next ids in order, deletes
    by id."""

    def __init__(self, x: np.ndarray, k: int, device):
        self.k, self.device = k, device
        self.x = to_tf32(torch.from_numpy(np.ascontiguousarray(x)).to(device))
        self.live = torch.ones(len(self.x), dtype=torch.bool, device=device)

    def insert(self, ids, rows) -> None:
        ids = np.asarray(ids, np.int64)
        if not np.array_equal(ids, len(self.x) + np.arange(len(ids))):
            raise ValueError("new rows come under the next ids in order")
        new = to_tf32(torch.from_numpy(np.ascontiguousarray(rows)).to(
            self.device))
        self.x = torch.cat([self.x, new])
        self.live = torch.cat([self.live, torch.ones(
            len(ids), dtype=torch.bool, device=self.device)])

    def delete(self, ids) -> None:
        self.live[torch.from_numpy(np.asarray(ids, np.int64)).to(
            self.device)] = False

    def __call__(self, q: np.ndarray):
        qt = to_tf32(torch.from_numpy(np.ascontiguousarray(q)).to(self.device))
        ids, scores = exact_topk(self.x, qt, self.k, self.live)
        return ids.cpu().numpy(), scores.cpu().numpy(), None
