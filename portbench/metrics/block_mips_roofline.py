"""`block_mips`' share of its roofline over the traced stretch: the least
time of the frozen `roofline_counts.block_mips` count, summed over the
stretch's batches, over the device time of the kernel's functions
(`bm_plan_kernel`, `bm_score_kernel`, `bm_merge_kernel`), in %.

Each batch's count takes the least work its answers needed: the (query,
page) pairs are the sum of its queries' pages (`SearchStats.pages`, both
rounds); the distinct pages read at least the largest single query's pages
(or, where the entry reports only the batch's total, its mean), each
needing one slot; the two rounds' top-k traffic counted once. Moves
`queries_per_s`."""
from .. import roofline_counts as rc


def read(ctx):
    t = ctx.trace
    dev_s = t.port_s("block_mips") if t is not None else None
    if not dev_s:
        return None
    m, b, k = ctx.meta, ctx.window.batch, ctx.k
    least = 0.0
    for total, largest in ctx.pages[ctx.stretch[0]:ctx.stretch[1]]:
        read_ = largest if largest is not None else -(-total // b)
        least += rc.block_mips(b, m["d"], k, m["page_rows"], read_, read_,
                               total)["roofline_s"]
    return 100.0 * least / dev_s
