"""Mode ``train``: fused train launches, ``fuse_steps`` steps of
``batch`` episodes a ``Trainer.train_step_fused`` call (the fused launch
``parallel/step.py::FusedTrainStep``), over the pool's batches in turn.

Set-up's first ``check.launches`` launches are the check's: the first
runs eagerly (the fused step's warm-up), the second captures the CUDA
graph and replays it. After the first the optimizer's momentum buffers,
after the last the parameters' change are kept, per leaf, as norms; with
every step's loss that is the evidence that ``check.train_reference``
is held against."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from benchmark import check, drivers, traffic
from benchmark.drivers import Window, span, sync


class Driver(drivers.Driver):

    def __init__(self, cfg, mix, seed, device):
        super().__init__(cfg, mix, seed, device)
        from pemp_tpu_torch.core import solver
        from pemp_tpu_torch.core.trainer import Trainer
        from pemp_tpu_torch.config import Run
        self.solver = solver
        pcfg, runtime = drivers.port_config(cfg, mix, "train")
        self.stack.enter_context(runtime.kernels())
        k = runtime.fuse_steps(self.device)
        if k != mix["fuse_steps"]:
            raise RuntimeError(f"the program runs {k} steps a launch, the "
                               f"mix asks for {mix['fuse_steps']}")
        model = drivers.port_model(cfg, pcfg, self.state,
                                   self.device).train()
        params = model.freeze()
        self.names = [n for n, p in model.named_parameters()
                      if p.requires_grad]
        optimizer = solver.make_optimizer(pcfg.tr, params,
                                          capturable=self.device.type
                                          == "cuda")
        trainer = Trainer(pcfg, Run(None, None), model, optimizer, params,
                          runtime, solver.LRPolicy(pcfg.tr, 1000),
                          self.device, weights=runtime.weights(model),
                          fuse_steps=k)
        trainer.dropout_generator.manual_seed(traffic.sub_seed(seed, 3))
        model.set_dropout_generator(trainer.dropout_generator)
        self.model, self.trainer, self.optimizer = model, trainer, optimizer
        self.params = params
        self.k = k
        self.next_launch = 0
        self.batches = [traffic.batch(self.pool, i, mix["batch"])
                        for i in range(mix["pool_batches"])]

    def call(self) -> torch.Tensor:
        """One launch of ``k`` steps, as ``Trainer._run_epoch`` makes it:
        the LRs drawn from the live schedule, then the fused call."""
        tr, k = self.trainer, self.k
        i = self.next_launch
        self.next_launch += 1
        n = len(self.batches)
        chunk = [self.batches[(i * k + j) % n] for j in range(k)]
        lrs = []
        for _ in chunk:
            lrs.append(tr.lr_policy.lr)
            tr.lr_policy.step_step()
        self.solver.set_lr(self.optimizer, lrs[-1])
        with span("bench.launch"):
            losses, _ = tr.train_step_fused(chunk, lrs)
        return losses

    def _norms(self, tensors: List[Optional[torch.Tensor]]) -> List[float]:
        """Each tensor's norm (0 for a missing one: a momentum buffer that
        no step made)."""
        zero = torch.zeros((), device=self.device)
        return torch.stack([zero if t is None else
                            torch.linalg.vector_norm(t.float())
                            for t in tensors]).cpu().tolist()

    def setup(self) -> None:
        start = [p.detach().clone() for p in self.params]
        launches = int(self.mix["check"]["launches"])
        losses = []
        for i in range(launches):
            losses.append(self.call())
            if i == 0:
                self.evidence["momentum"] = dict(zip(self.names, self._norms(
                    [self.optimizer.state.get(p, {}).get("momentum_buffer")
                     for p in self.params])))
        self.evidence["change"] = dict(zip(self.names, self._norms(
            [p.detach() - s for p, s in zip(self.params, start)])))
        del start
        self.evidence["losses"] = torch.cat(losses).double().cpu().tolist()
        for _ in range(int(self.mix["warmup_calls"])):
            self.call()
        sync(self.device)

    def window(self, seconds: float) -> Window:
        w = Window()
        kept = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            kept.append(self.call())
            w.call_s.append(time.perf_counter() - t)
        with span("bench.fetch"):
            host = torch.stack(kept).cpu()         # closes the window
        w.seconds = time.perf_counter() - t0
        w.calls = len(kept)
        w.episodes = w.calls * self.k * self.mix["batch"]
        w.nonfinite = int((~torch.isfinite(host)).sum())
        w.failed = w.nonfinite * self.mix["batch"]
        return w

    def check(self, log=None) -> Dict[str, float]:
        """The check's launches on the reference, against the evidence."""
        ref = check.train_reference(self.cfg, self.mix, self.pool,
                                    self.state, self.seed, self.device)
        values = check.compare_train(self.evidence, ref)
        if log is not None:
            left = len(ref["momentum"]) - len(check.kept_leaves(ref))
            print(f"check losses program {self.evidence['losses']} "
                  f"reference {ref['losses']}; leaves left out {left} of "
                  f"{len(ref['momentum'])}", file=log)
        return values

    def flops_per_call(self) -> float:
        """FLOPs of one launch on the plain reference, counted by
        ``FlopCounterMode`` on the meta device at the cell's shapes:
        ``fuse_steps`` steps of forward, backward and update. It does not
        depend on how the program computes."""
        from torch.utils.flop_counter import FlopCounterMode
        ref = self.reference
        ep = drivers.meta_episodes(self.cfg, self.mix)
        with torch.device("meta"):
            model = ref.build(self.cfg).train()
            opt = ref.optimizer(self.cfg, model.trainable())
            counter = FlopCounterMode(display=False)
            with counter:
                ref.train_step(model, opt, ep, self.cfg)
        return float(counter.get_total_flops() * self.mix["fuse_steps"])


def control(cell, seed: int, device, faults: bool = True) -> Dict:
    """The control's readings on ``seed``: the reference at the precision
    below the configuration's (``fp8``) in the program's place, and with
    ``faults`` the fault ``half_batch`` planted in the reference, each
    held against the float32 reference by the check's numbers. A step
    that leaves the state unchanged reads 1 on ``change_gap`` by its
    definition and needs no run."""
    cfg, mix = cell.config, cell.mix
    pool = traffic.episodes(cfg, mix, seed, device)
    state = drivers.seeded_state(cfg, seed, device)
    ref = check.train_reference(cfg, mix, pool, state, seed, device)
    rec: Dict = {"reference_losses": ref["losses"]}
    runs = [("control", {"precision": "fp8"})]
    if faults:
        runs.append(("half_batch", {"fault": "half_batch"}))
    for name, kw in runs:
        got = check.train_reference(cfg, mix, pool, state, seed, device,
                                    **kw)
        rec[name] = check.compare_train(got, ref)
        rec[f"{name}_losses"] = got["losses"]
    return rec
