"""The stream layer (`stream/mutable.py` `snapshot`): host milliseconds of
an explicit `snapshot()` call a step, made only in a traced run, after the
step's writes and before the search that would make the snapshot anyway:
the copy of the tombstones and the delta prefix to the card. Averaged over
the window's steps. Moves `queries_per_s.churn`."""


def read(ctx):
    s = ctx.snapshot_s
    return 1e3 * sum(s) / len(s) if s else None
