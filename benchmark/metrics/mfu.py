"""mfu.<cell kind>: 100 x the FLOPs of the window's calls, counted on the
plain reference (the mode driver's ``flops_per_call``: forward, backward and
update of each step for training, the forward for evaluation), over the
window's seconds times the card's dense bf16 peak (``arith.PEAK_BF16``).
The window is the traced run's, outside the profiled sub-window."""

from benchmark import arith


def read(ctx):
    peak = arith.peak_bf16(ctx.device_name)
    if peak is None or not ctx.flops_per_call:
        return None
    w = ctx.window
    return 100.0 * ctx.flops_per_call * w.calls / w.seconds / peak
