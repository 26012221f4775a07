"""The 95th percentile of every batch's latency in the window (host clock,
from the call to its ids and scores on the host), in milliseconds."""
from .. import traffic


def read(ctx):
    lat = ctx.window.latencies_s
    return 1e3 * traffic.percentile(lat, 95.0) if lat else None
