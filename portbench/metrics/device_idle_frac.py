"""The device's idle share over the traced stretch of the window: one
minus the union of every kernel's and copy's interval over the stretch's
wall time (`torch.profiler`). Moves `queries_per_s`."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
