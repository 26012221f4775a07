"""Verification (`core/search_device.py` -> `ops.block_mips`): the data
pages a query verifies (`SearchStats.pages`, the paper's page-access
metric; in a changing catalog the base search's), over every query of the
window. Moves `queries_per_s`."""


def read(ctx):
    total = sum(p[0] for p in ctx.pages)
    queries = ctx.window.n_batches * ctx.window.batch
    return total / queries if queries else None
