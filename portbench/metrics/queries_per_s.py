"""Every query answered in the window over the window's seconds (host
clock, from the first batch sent to the last batch's results on the
host)."""


def read(ctx):
    w = ctx.window
    return w.n_batches * w.batch / w.seconds if w.n_batches else None
