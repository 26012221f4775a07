"""`sketch_scores`' share of its roofline over the traced stretch (the
prefilter, `prefilter_round1` -> `ops.sketch_scores`, one launch a batch):
the frozen `roofline_counts.sketch_scores` count at the index's shapes
(B, d, NB, M, K, d / M) for each launch in the stretch, over the device
time of `sketch_kernel`, in %. Moves `queries_per_s`."""
from .. import roofline_counts as rc


def read(ctx):
    t = ctx.trace
    dev_s = t.port_s("sketch_scores") if t is not None else None
    if not dev_s or not ctx.meta["sk_subspaces"]:
        return None
    m, b = ctx.meta, ctx.window.batch
    one = rc.sketch_scores(b, m["d"], m["n_blocks"], m["sk_subspaces"],
                           m["sk_codewords"], m["d"] // m["sk_subspaces"])
    return 100.0 * t.port_n("sketch_scores") * one["roofline_s"] / dev_s
