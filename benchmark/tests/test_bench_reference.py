"""The plain reference against the program's plain path (its CPU path:
the kernels' plain versions) at a toy size, both in float32 on the same
seeded weights and episodes: the forward, the loss, the gradients, the
update and the evaluator's answers."""

from __future__ import annotations

import pytest
import torch

from benchmark import check, drivers, traffic
from benchmark.reference import pemp as reference
from benchmark.tests.conftest import TOY_MIXES, toy_cell

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _setup(name, seed=11):
    cell = toy_cell(name, **TOY_MIXES[name])
    cfg, mix = cell.config, cell.mix
    pool = traffic.episodes(cfg, mix, seed, CPU)
    state = drivers.seeded_state(cfg, seed, CPU)
    return cfg, mix, pool, state


@pytest.mark.parametrize("name", ["pemp-s1-r50.serve-b1",
                                  "pemp-s2-r50.eval-cascade-b1"])
def test_eval_answers(name):
    cfg, mix, pool, state = _setup(name)
    pcfg, runtime = drivers.port_config(cfg, mix, "test")
    model = drivers.port_model(cfg, pcfg, state, CPU)
    step = runtime.eval_step(model, CPU)
    b = traffic.batch(pool, 0, mix["batch"])
    counts, losses = step(b)
    ref = check.eval_reference(cfg, pool, list(range(mix["batch"])), state,
                               CPU)
    for e in range(mix["batch"]):
        assert losses[e] == pytest.approx(ref[e][1], rel=1e-4)
        assert abs(counts[e] - ref[e][0]).sum() <= 2   # near-ties at most


def test_train_step_and_update():
    name = "pemp-s1-r50.train-b4-fuse8"
    cfg, mix, pool, state = _setup(name)
    pcfg, runtime = drivers.port_config(cfg, mix, "train")
    model = drivers.port_model(cfg, pcfg, state, CPU).train()
    ref = check.reference_model(cfg, state, CPU, "f32").train()
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    model.set_dropout_generator(gens[0])
    reference.set_generator(ref, gens[1])
    from pemp_tpu_torch.core import solver
    from pemp_tpu_torch.parallel.step import unpack_batch
    params = model.freeze()
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    opt = solver.make_optimizer(pcfg.tr, params)
    ropt = reference.optimizer(cfg, ref.trainable())
    assert set(names) == set(ropt.params)
    b = traffic.batch(pool, 0, mix["batch"])
    u = unpack_batch(b)
    logits, aux = runtime.apply_train(model, u)
    loss = runtime.compute_loss(logits, u, aux)
    loss.backward()
    solver.clip_gradients(params, pcfg.tr.grad_clip)
    solver.step(opt, solver.lr_tensor(CPU).fill_(pcfg.tr.lr))
    rloss = reference.train_step(ref, ropt, check.unpack(b), cfg)
    assert float(loss.detach()) == pytest.approx(float(rloss), rel=1e-5)
    # the optimizer's state after one step: the clipped gradient plus
    # weight decay, leaf by leaf (a drawn ResNet's float32 gradients
    # differ from float64's by up to 0.3 % of a leaf's norm)
    buf = {n: opt.state[p]["momentum_buffer"]
           for n, p in model.named_parameters() if p.requires_grad}
    worst = max(float((buf[n] - ropt.buf[n]).norm() / ropt.buf[n].norm())
                for n in names)
    assert worst < 1e-2
    # the parameters' change by the check's measure: the gap of the norms
    # (a difference of float32 parameters rounds each element of a 1e-6
    # change by about 1 %; the norms average that out)
    after = dict(model.named_parameters())
    gap = max(abs(float((after[n] - state[n]).norm())
                  - float((ropt.params[n] - state[n]).norm()))
              / float((ropt.params[n] - state[n]).norm()) for n in names)
    assert gap < 1e-3
