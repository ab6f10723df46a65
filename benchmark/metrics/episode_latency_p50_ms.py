"""episode_latency_p50_ms.<cell kind>: the median of the same times as
episode_latency_p95_ms (host clock): the evaluator's steady cost, which
a tail hides less well."""

from benchmark import arith


def read(ctx):
    return arith.percentile(ctx.window.call_s, 50) * 1e3
