"""Recall@k of the ids the window returned against the reference's exact
top-k, averaged over the queries the reference checks (a sample of the
window's batches drawn from the seed)."""


def read(ctx):
    r = ctx.readings
    return r["recall"] if r.get("queries") else None
