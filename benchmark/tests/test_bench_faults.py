"""The harness's check against a broken program: a run at a toy size on
the CPU (the card's look skipped, the rest of ``run_cell`` as it is),
with the timed path broken underneath, comes out not correct; the same
run unbroken comes out correct. One cell of each kind, each fault it can
have (one card: no exchange between cards to leave out)."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import TOY_MIXES, toy_cell

CPU = torch.device("cpu")
TRAIN = "pemp-s1-r50.train-b4-fuse8"
EVALS = ["pemp-s2-r50.eval-cascade-b1", "pemp-s1-r50.serve-b1"]


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def run_toy(name, seed=5):
    cell = toy_cell(name, **TOY_MIXES[name])
    return run.run_cell(cell, seed, 0.3, False, CPU, time.perf_counter())


def runtime_class(name):
    from pemp_tpu_torch.entry import pemp_stage1, pemp_stage2
    return (pemp_stage2.Stage2Runtime if "s2" in name
            else pemp_stage1.Stage1Runtime)


@pytest.mark.parametrize("name", [TRAIN] + EVALS)
def test_sound_run_is_correct(name):
    out = run_toy(name)
    assert out["correct"], out["compared"]


def test_train_state_unchanged(monkeypatch):
    from pemp_tpu_torch.core import solver
    monkeypatch.setattr(solver, "step", lambda optimizer, lr: None)
    out = run_toy(TRAIN)
    assert not out["correct"]
    assert out["compared"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch(monkeypatch):
    cls = runtime_class(TRAIN)
    loss_fn = cls.compute_loss

    def half(self, logits, batch, aux):
        n = logits.shape[0] // 2
        return loss_fn(self, logits[:n], {k: v[:n] for k, v in
                                          batch.items()}, aux)
    monkeypatch.setattr(cls, "compute_loss", half)
    assert not run_toy(TRAIN)["correct"]


def test_train_answer_altered(monkeypatch):
    cls = runtime_class(TRAIN)
    loss_fn = cls.compute_loss
    monkeypatch.setattr(cls, "compute_loss", lambda self, *a:
                        loss_fn(self, *a) * 1.05)
    out = run_toy(TRAIN)
    assert not out["correct"]
    assert out["compared"]["loss_gap"]["value"] > 0.04


@pytest.mark.parametrize("name", EVALS)
def test_eval_half_batch(monkeypatch, name):
    cls = runtime_class(name)
    apply = cls.apply_eval

    def half(self, model, batch):
        n = (len(batch["sup_rgb"]) + 1) // 2
        logits = apply(self, model, {k: v[:n] for k, v in batch.items()})
        return torch.cat([logits, logits])[:len(batch["sup_rgb"])]
    monkeypatch.setattr(cls, "apply_eval", half)
    if name.endswith("-b1"):
        # one episode a call has no half to leave out: the call answers
        # the pool's previous episode instead
        seen = []

        def stale(self, model, batch):
            seen.append({k: v.clone() for k, v in batch.items()})
            return apply(self, model, seen[-2] if len(seen) > 1
                         else seen[-1])
        monkeypatch.setattr(cls, "apply_eval", stale)
    assert not run_toy(name)["correct"]


@pytest.mark.parametrize("name", EVALS)
def test_eval_answer_altered(monkeypatch, name):
    cls = runtime_class(name)
    apply = cls.apply_eval

    def flipped(self, model, batch):
        logits = apply(self, model, batch).clone()
        logits[0] = logits[0].flip(-1)          # the first answer's classes
        return logits
    monkeypatch.setattr(cls, "apply_eval", flipped)
    assert not run_toy(name)["correct"]
