"""conv_ms.<cell kind>: the card's time in convolution kernels (the
``conv`` group of ``trace.GROUPS``) in the profiled sub-window, per train
step or per eval call (an episode in the serve cell), in ms."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace["timeline"].by_group().get("conv", 0.0)
    return t * 1e3 / ctx.trace["steps"] if t > 0 else None
