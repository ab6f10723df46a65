"""backbone_idle_ms.<cell kind>: the card's idle ms a call inside the
program's spans ``model.backbone`` (each backbone a call runs: two in the
cascade), over the calls' root spans ``evaluator.step`` in the profiled
sub-window. None where the program records no such span."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms_per(ctx, ["model.backbone"], spans.EVAL_ROOT)
