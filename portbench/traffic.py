"""The one generator of query traffic, driven by a mix's data file.

One client runs a closed loop: it sends its next batch when the last
batch's ids and scores are on the host. A mix (`traffic/<name>.json`)
gives:

  batch                queries a batch (B)
  k                    results a query
  warmup_batches       batches searched before the window, drawn like the
                       window's (they are set-up)
  pool_queries_per_s   the rate the query pool is sized for: the window
                       holds distinct batches up to this rate, and only
                       past it does the pool start again from its head
  check_batches        batches of the window the reference checks, drawn
                       from the seed
  trace_after_frac     where the traced stretch of a `--trace 1` run starts,
                       as a share of the window
  trace_batches        batches in the traced stretch
  entry                (optional) the entry point the mix needs, in place
                       of the configuration's: a mix with writes needs an
                       index that takes them
  writes               (optional) a catalog that changes while it is
                       queried: before the warm-up, ``prefill_rows`` new
                       rows are inserted and ``pre_delete_base`` rows of
                       the corpus deleted; then every step (a batch of the
                       warm-up or the window) inserts ``insert_rows`` new
                       rows and deletes ``delete_base`` corpus rows and
                       ``delete_delta`` inserted rows, each drawn uniformly
                       from the live ones, before its search

The queries come from the configuration's own query recipe, all from one
draw, so warm-up and window share one distribution. New rows come from the
corpus's own recipe (`corpus.new_rows`), and the whole schedule of writes
is drawn before the warm-up, so the window only applies it.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from . import corpus as _corpus


@dataclass
class Batches:
    warmup: np.ndarray     # (W, B, d)
    pool: np.ndarray       # (P, B, d)


def steps(traffic: dict, seconds: float) -> tuple:
    """(warm-up batches, window batches the pool holds)."""
    b = int(traffic["batch"])
    return (int(traffic["warmup_batches"]),
            max(1, math.ceil(float(traffic["pool_queries_per_s"]) * seconds
                             / b)))


def make_batches(config: dict, traffic: dict, seed: int,
                 seconds: float) -> Batches:
    """Warm-up and window batches of run ``seed`` for a window of
    ``seconds``."""
    w, p = steps(traffic, seconds)
    b = int(traffic["batch"])
    q = _corpus.make(config["queries"], (w + p) * b, config["d"],
                     _corpus.derive(seed, "queries"))
    q = q.reshape(w + p, b, -1)
    return Batches(warmup=q[:w], pool=q[w:])


NEVER = np.iinfo(np.int64).max      # `Writes.died` of a row never deleted


@dataclass
class Writes:
    """A catalog's writes, drawn whole from the seed. The corpus's rows are
    ids 0 .. n-1, new rows n, n+1, ... in the order they are inserted
    (``rows[j]`` is id n + j). Step t is the t-th batch of the warm-up and
    then the window: its writes are applied before its search. ``born`` /
    ``died`` give each id the first step whose search sees it live / no
    longer live (-1: from before step 0)."""
    n: int
    rows: np.ndarray               # (R, d) every new row
    prefill: int                   # new rows inserted in set-up
    pre_deleted: np.ndarray        # corpus ids deleted in set-up
    inserts: int                   # new rows a step
    deletes: np.ndarray            # (S, deletes a step) ids
    born: np.ndarray               # (n + R,) int64
    died: np.ndarray               # (n + R,) int64

    @property
    def n_steps(self) -> int:
        return len(self.deletes)

    def prefill_items(self):
        return (self.n + np.arange(self.prefill, dtype=np.int64),
                self.rows[:self.prefill])

    def step_inserts(self, t: int):
        """(ids, rows) step ``t`` inserts."""
        j = self.prefill + t * self.inserts
        return (self.n + np.arange(j, j + self.inserts, dtype=np.int64),
                self.rows[j:j + self.inserts])

    def live(self, t: int) -> np.ndarray:
        """(n + R,) whether each id is live at step ``t``'s search."""
        return (self.born <= t) & (self.died > t)

    def new_live(self, t: int) -> int:
        """New rows live at step ``t``'s search."""
        return int(((self.born[self.n:] <= t)
                    & (self.died[self.n:] > t)).sum())


def make_writes(config: dict, traffic: dict, seed: int,
                n_steps: int) -> Writes:
    """The writes of run ``seed`` over ``n_steps`` steps, as the mix's
    ``writes`` gives them (the module's docstring)."""
    w = traffic["writes"]
    n = int(config["n"])
    pre, ins = int(w["prefill_rows"]), int(w["insert_rows"])
    n_base, n_delta = int(w["delete_base"]), int(w["delete_delta"])
    total = pre + ins * n_steps
    stream = _corpus.derive(seed, "writes")
    rows = _corpus.new_rows(config, total, stream)
    rng = np.random.default_rng([stream, 1])
    born = np.full(n + total, -1, np.int64)
    born[n + pre:] = np.arange(total - pre) // max(1, ins)
    died = np.full(n + total, NEVER, np.int64)
    pre_deleted = rng.choice(n, size=int(w["pre_delete_base"]),
                             replace=False).astype(np.int64)
    died[pre_deleted] = -1
    base = np.delete(np.arange(n, dtype=np.int64), pre_deleted)
    nb = len(base)
    delta = list(range(n, n + pre))
    deletes = np.empty((n_steps, n_base + n_delta), np.int64)
    for t in range(n_steps):
        j = n + pre + t * ins
        delta.extend(range(j, j + ins))
        out = []
        for _ in range(n_base):         # swap-remove: uniform, no repeats
            i = int(rng.integers(nb))
            out.append(int(base[i]))
            nb -= 1
            base[i] = base[nb]
        for _ in range(n_delta):
            i = int(rng.integers(len(delta)))
            out.append(delta[i])
            delta[i] = delta[-1]
            delta.pop()
        deletes[t] = out
        died[out] = t
    return Writes(n=n, rows=rows, prefill=pre, pre_deleted=pre_deleted,
                  inserts=ins, deletes=deletes, born=born, died=died)


@dataclass
class Window:
    """What the closed loop saw: one entry a batch, in order."""
    batch: int
    latencies_s: List[float] = field(default_factory=list)
    pool_index: List[int] = field(default_factory=list)
    ids: List[np.ndarray] = field(default_factory=list)
    scores: List[np.ndarray] = field(default_factory=list)
    pages: list = field(default_factory=list)
    failed_batches: int = 0
    error: Optional[str] = None
    pool_size: int = 0
    t_start: float = 0.0
    t_end: float = 0.0

    @property
    def n_batches(self) -> int:
        return len(self.latencies_s)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start

    @property
    def wrapped(self) -> bool:
        """Whether the window ran past the pool and sent batches again."""
        return self.n_batches > self.pool_size


def closed_loop(search: Callable, pool: np.ndarray, seconds: float,
                on_batch: Optional[Callable] = None) -> Window:
    """Send the pool's batches one after another for ``seconds``: each batch
    is timed on the host clock from the call to its ids and scores on the
    host. The window ends with the batch that finishes past ``seconds``;
    its time counts. ``search(q)`` returns (ids, scores, pages) with ids
    and scores as host arrays. ``on_batch(i)``, if given, runs before batch
    ``i`` is sent (the tracer's hook). A batch that raises ends the window
    and counts as failed."""
    win = Window(batch=int(pool.shape[1]), pool_size=len(pool))
    clock = time.perf_counter
    i = 0
    win.t_start = clock()
    deadline = win.t_start + seconds
    while True:
        if on_batch is not None:
            on_batch(i)
        j = i % len(pool)
        t0 = clock()
        try:
            ids, scores, pages = search(pool[j])
        except Exception as e:        # a failed batch ends the run's window
            win.failed_batches += 1
            win.error = f"{type(e).__name__}: {e}"
            win.t_end = clock()
            break
        t1 = clock()
        win.latencies_s.append(t1 - t0)
        win.pool_index.append(j)
        win.ids.append(ids)
        win.scores.append(scores)
        win.pages.append(pages)
        i += 1
        if t1 >= deadline:
            win.t_end = t1
            break
    if on_batch is not None:
        on_batch(i)
    return win


def rate_by_part(win: Window, parts: int) -> list:
    """Queries a second in each of ``parts`` equal runs of the window's
    batches (in order): how steady the rate was through the window."""
    lat = np.asarray(win.latencies_s, np.float64)
    return [win.batch * len(c) / c.sum()
            for c in np.array_split(lat, parts) if len(c)]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values`` (linear between order
    statistics, numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def check_sample(win: Window, n_check: int, seed: int) -> np.ndarray:
    """Indices of the window's batches the reference checks: ``n_check``
    of them (all, if the window has fewer), drawn from the seed."""
    n = win.n_batches
    if n <= n_check:
        return np.arange(n)
    rng = np.random.default_rng(_corpus.derive(seed, "sample"))
    return np.sort(rng.choice(n, size=n_check, replace=False))
