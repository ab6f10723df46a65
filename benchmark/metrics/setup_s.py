"""setup_s: seconds from the process's start to the first timed call:
imports, the card's start, the pool and the weights, the program's
build, kernel builds (on a checkout's first run), warm-up and, for a
training cell, the check's launches (host clock)."""


def read(ctx):
    return ctx.setup_s
