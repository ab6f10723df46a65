"""eval_episodes_per_s: every episode whose counts the window fetched,
over the window's seconds (host clock)."""

from benchmark import arith


def read(ctx):
    return arith.rate(ctx.window.episodes, ctx.window.seconds)
