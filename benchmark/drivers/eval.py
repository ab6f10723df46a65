"""Mode ``eval``: the evaluator's step (``core/evaluator.py::
make_fast_eval_step`` through ``runtime.eval_step``) on batches of
``batch`` episodes, one call after the other; each call ends in the
fetch of its counts and losses. Every answer of the window is kept with
its pool episode, and a sample drawn from the seed is held against the
reference (``check.eval_reference``)."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from benchmark import check, drivers, traffic
from benchmark.drivers import Window, span, sync


class Driver(drivers.Driver):

    def __init__(self, cfg, mix, seed, device):
        super().__init__(cfg, mix, seed, device)
        pcfg, runtime = drivers.port_config(cfg, mix, "test")
        self.stack.enter_context(runtime.kernels())
        self.model = drivers.port_model(cfg, pcfg, self.state, self.device)
        self.step_fn = runtime.eval_step(self.model, self.device)
        self.n_batches = mix["pool_batches"]
        self.next_call = 0

    def call(self):
        i = self.next_call % self.n_batches
        self.next_call += 1
        b = traffic.batch(self.pool, i, self.mix["batch"])
        with span("bench.eval_step"):
            counts, losses = self.step_fn(b)
        return i, counts, losses

    def setup(self) -> None:
        for _ in range(int(self.mix["warmup_calls"])):
            self.call()
        sync(self.device)

    def window(self, seconds: float) -> Window:
        w = Window()
        answers = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            answers.append(self.call())
            w.call_s.append(time.perf_counter() - t)
        w.seconds = time.perf_counter() - t0
        w.calls = len(answers)
        w.episodes = w.calls * self.mix["batch"]
        w.nonfinite = int(sum((~np.isfinite(lo)).sum() for _, _, lo in
                              answers))
        w.failed = w.nonfinite
        self.evidence["answers"] = answers
        return w

    def check(self, log=None) -> Dict[str, float]:
        """A sample of the window's answers against the reference's."""
        picks = check.eval_picks(self.evidence["answers"], self.mix,
                                 self.seed)
        ref = check.eval_reference(self.cfg, self.pool,
                                   [e for e, _, _ in picks], self.state,
                                   self.device)
        if log is not None:
            gaps = sorted(abs(lo - ref[e][1]) / abs(ref[e][1])
                          for e, _, lo in picks)
            print(f"check episodes {len(picks)} loss gaps {gaps}", file=log)
        return check.compare_eval(picks, ref)

    def flops_per_call(self) -> float:
        """FLOPs of one call's forward on the plain reference, counted by
        ``FlopCounterMode`` on the meta device at the cell's shapes."""
        from torch.utils.flop_counter import FlopCounterMode
        ep = drivers.meta_episodes(self.cfg, self.mix)
        with torch.device("meta"):
            model = self.reference.build(self.cfg).eval()
            counter = FlopCounterMode(display=False)
            with counter, torch.no_grad():
                self.reference.logits(model, ep)
        return float(counter.get_total_flops())


def control(cell, seed: int, device, faults: bool = True) -> Dict:
    """The control's readings on ``seed``: the reference at the precision
    below the configuration's (``fp8``) in the program's place, on the
    sample of episodes a window's check would draw, against the float32
    reference. (An eval cell's faults are planted in the program: see
    ``benchmark/tests/test_bench_faults.py``.)"""
    cfg, mix = cell.config, cell.mix
    pool = traffic.episodes(cfg, mix, seed, device)
    state = drivers.seeded_state(cfg, seed, device)
    rng = np.random.default_rng(traffic.sub_seed(seed, 5))
    n = len(pool["cls"])
    idx = sorted(rng.choice(n, min(n, mix["check"]["episodes"]),
                            replace=False).tolist())
    ref = check.eval_reference(cfg, pool, idx, state, device)
    ctl = check.eval_reference(cfg, pool, idx, state, device, "fp8")
    return {"control": check.compare_eval([(e, *ctl[e]) for e in idx], ref),
            "control_episode_gaps": sorted(
                abs(ctl[e][1] - ref[e][1]) / abs(ref[e][1]) for e in idx)}
