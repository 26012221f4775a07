"""The search driver's PyTorch ops (`core/search_device.py`,
`core/search_graph.py`: the frontend's masks, reductions and gathers, the
tile plan, the top-k glue, the rescore): device milliseconds a batch of
every kernel that is not one of the port's own (`kernels.json`), copies
left out, over the traced stretch. Moves `queries_per_s`."""


def read(ctx):
    t = ctx.trace
    if t is None or t.batches == 0 or t.busy_s <= 0:
        return None
    return 1e3 * t.torch_s() / t.batches
