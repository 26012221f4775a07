"""`mips_score`'s share of its roofline over the traced stretch (the delta
segment's exact scores in `search_segments`' merge, one launch a step): the
frozen `roofline_counts.mips_score` count at (R, B, d), R the new rows live
at each step's search (the least the answer needs; the kernel scores the
whole power-of-two prefix of the delta), over the device time of the
kernel's functions, in %. Moves `queries_per_s.churn`."""
from .. import roofline_counts as rc


def read(ctx):
    t, w = ctx.trace, ctx.writes
    dev_s = t.port_s("mips_score") if t is not None else None
    if not dev_s or w is None:
        return None
    b, d = ctx.window.batch, ctx.meta["d"]
    least = sum(rc.mips_score(w.new_live(ctx.first_step + i), b, d)
                ["roofline_s"] for i in range(*ctx.stretch))
    return 100.0 * least / dev_s
