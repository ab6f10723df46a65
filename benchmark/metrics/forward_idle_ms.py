"""forward_idle_ms.<cell kind>: the card's idle ms a call inside the
program's span ``evaluator.forward`` (the model's forward), over the
calls' root spans ``evaluator.step`` in the profiled sub-window; from the
program's spans and the device trace on one clock. None where the program
records no such span."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms_per(ctx, ["evaluator.forward"], spans.EVAL_ROOT)
