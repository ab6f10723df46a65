"""norm_eltwise_ms.<cell kind>: the card's time in normalisation,
reduction and elementwise kernels (the ``fusion`` group of
``trace.GROUPS``) in the profiled sub-window, per step, in ms."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace["timeline"].by_group().get("fusion", 0.0)
    return t * 1e3 / ctx.trace["steps"] if t > 0 else None
