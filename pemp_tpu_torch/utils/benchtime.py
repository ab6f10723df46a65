"""The best-of-rounds measurement loop and the no-progress watchdog that
the port's benchmarks share.

Counterpart of ``pemp_tpu/utils/benchtime.py``, with the same semantics:
a benchmark takes the best of many short rounds within a time budget
and, when EVERY round's per-launch latency stayed above
``slow_launch_s`` (a property of the host's link to the device, not of
the workload, so slower configurations do not trip it), keeps sampling
up to ``extend_s`` longer: one healthy round is enough for a faithful
number. On a healthy card no round is that slow and the budget alone
bounds the loop. Off the card (``--device cpu``, as the tests run) a
short budget of its own applies and there is no extension.

One copy of the heuristic: ``tools/bench.py``, ``tools/bench_zoo.py``
and ``tools/bench_train_zoo.py`` share it. The module imports neither
torch nor numpy, so a benchmark arms its watchdog before ``import torch``.
"""

import os
import sys
import threading
import time


def arm_watchdog(label: str, *, watchdog_s=None,
                 env: str = "PEMP_BENCH_WATCHDOG_S",
                 default_s: float = 2700.0, exit_code=3, line=None):
    """A NO-PROGRESS watchdog: if no ``progress()`` call arrives within
    the window (``watchdog_s``, else ``$env``, else ``default_s``), a
    WATCHDOG line goes to stderr, ``line`` (when given) to stdout (a
    benchmark's one-line contract, its zero reading), and the process
    exits ``exit_code``. Every completed launch or round refreshes the
    deadline, so a slow but live device never trips it; a launch or the
    first device touch that hangs does.

    Returns ``(progress, disarm)``. ``watchdog_s`` <= 0 disables it.
    ``exit_code=None`` prints and does not exit (tests).
    """
    ws = (float(os.environ.get(env, str(default_s)))
          if watchdog_s is None else float(watchdog_s))
    done = threading.Event()
    last = [time.monotonic()]

    def progress():
        last[0] = time.monotonic()

    def disarm():
        done.set()

    if ws <= 0:
        return progress, disarm

    def run():
        poll = min(15.0, max(0.05, ws / 4))
        while not done.wait(timeout=poll):
            if time.monotonic() - last[0] <= ws:
                continue
            if done.is_set():
                return
            print(f"WATCHDOG: {label} — no completed launch for "
                  f"{ws:.0f}s (device wedged)", file=sys.stderr, flush=True)
            if line is not None:
                print(line, flush=True)
            if exit_code is not None:
                os._exit(exit_code)
            return

    threading.Thread(target=run, daemon=True).start()
    return progress, disarm


def budget_s(default_s: float, env: str = "PEMP_BENCH_BUDGET_S") -> float:
    """The on-card round budget: ``$env`` when set (a short run: on a
    healthy card one round is a faithful reading), else ``default_s``."""
    return float(os.environ.get(env, str(default_s)))


def best_of_rounds(timed_round, on_card, *, budget_s=360.0, extend_s=420.0,
                   slow_launch_s=5.0, off_card_budget_s=30.0,
                   max_rounds=200, progress=None):
    """Run ``timed_round() -> (episodes_per_s, per_launch_seconds)``
    repeatedly and return the best episodes/s seen.

    Samples until ``budget_s`` (``off_card_budget_s`` off the card); if
    by then no round's per-launch latency ever dropped to
    ``slow_launch_s``, sampling continues up to ``extend_s`` longer
    (on the card only) for one healthy round. At most ``max_rounds``
    rounds. ``progress`` (e.g. from ``arm_watchdog``) is called after
    every completed round.
    """
    best, best_launch = 0.0, float("inf")
    budget = budget_s if on_card else off_card_budget_s
    deadline = time.time() + budget
    hard_stop = deadline + (extend_s if on_card else 0.0)
    for _ in range(max_rounds):
        eps, launch_s = timed_round()
        if progress is not None:
            progress()
        best = max(best, eps)
        best_launch = min(best_launch, launch_s)
        now = time.time()
        if now > deadline and (best_launch <= slow_launch_s or not on_card):
            break
        if now > hard_stop:
            break
    return best
