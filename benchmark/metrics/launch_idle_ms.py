"""launch_idle_ms.<cell kind>: the card's idle ms a train step inside the
fused launch's own spans: ``fused.wire`` (the k batches to the device),
``.slots`` (the copies into the graph's inputs and the LRs), ``.replay``
(the graph's launch), ``.outputs`` (the losses' clones), and ``.warm_up``
or ``.capture`` where one falls in the window, over the launches' root
spans ``fused.launch`` times the mix's ``fuse_steps`` in the profiled
sub-window. None where the program records no such span."""

from benchmark import spans

NAMES = ["fused.wire", "fused.slots", "fused.replay", "fused.outputs",
         "fused.warm_up", "fused.capture"]


def read(ctx):
    return spans.idle_ms_per(ctx, NAMES, spans.LAUNCH_ROOT,
                             int(ctx.mix["fuse_steps"]))
