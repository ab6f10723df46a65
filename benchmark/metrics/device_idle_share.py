"""device_idle_share.<cell kind>: 100 x (1 - the union of the card's
kernel and copy intervals over the profiled sub-window's wall time), from
the device trace; never a sum of kernel times, which overlap."""


def read(ctx):
    if ctx.trace is None:
        return None
    tl = ctx.trace["timeline"]
    busy = tl.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / tl.window_s)
