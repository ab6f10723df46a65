"""launch_ms_p50.<cell kind>: the median host time of one call of the
trainer's fused step (fuse_steps steps) in the window. Once the host runs
ahead of the card a call waits for the card, so this is the launch's
steady cost, host and card together (host clock)."""

from benchmark import arith


def read(ctx):
    return arith.percentile(ctx.window.call_s, 50) * 1e3
