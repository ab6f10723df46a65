"""train_episodes_per_s: every episode trained in the window over the
window's seconds, from its first launch to the fetch of its losses that
closes it (host clock)."""

from benchmark import arith


def read(ctx):
    return arith.rate(ctx.window.episodes, ctx.window.seconds)
