"""episode_latency_p95_ms: the 95th percentile, over every call of the
window, of the host time from the call to its fetched counts; a call is
one episode in the cells that report it (host clock)."""

from benchmark import arith


def read(ctx):
    return arith.percentile(ctx.window.call_s, 95) * 1e3
