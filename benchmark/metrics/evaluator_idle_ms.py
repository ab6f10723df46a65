"""evaluator_idle_ms.<cell kind>: the card's idle ms a call inside the
evaluator's own spans around the forward: ``evaluator.wire`` (the batch to
the device), ``.labels`` (the query GT to the device), ``.metrics`` (the
resize to each GT, counts and losses) and ``.fetch`` (the copy to the
host), over the calls' root spans ``evaluator.step`` in the profiled
sub-window. None where the program records no such span."""

from benchmark import spans

NAMES = ["evaluator.wire", "evaluator.labels", "evaluator.metrics",
         "evaluator.fetch"]


def read(ctx):
    return spans.idle_ms_per(ctx, NAMES, spans.EVAL_ROOT)
