"""Worlds of two port processes over gloo on the CPU against one process
at the global batch (``tests/torch_parallel_worker.py``; every process
and every collective with a timeout):

- the global batch norm (forward, input and parameter gradients, running
  statistics), the global loss denominators of ``cross_entropy`` (with
  ignored pixels) and ``cedt``, the gathers and the host broadcasts, at
  float64 within 1e-10 of one process on the concatenated batch;
- two PEMP stage-1 train steps (a ResNet of one block a stage, 33x33,
  float64, cedt, DropBlock on, compact wire, prefetcher) through the
  entry runtime: losses and parameters (running statistics included)
  within 1e-7 of one process at twice the batch, and the same on both
  ranks;
- the same steps fused (``dev.fuse_steps=2``, a chunk and a serial tail;
  on the CPU a chunk is two eager steps): both ranks alike, within 1e-7
  of one process at twice the batch, whose fused run equals its serial
  one bit for bit (the JAX package's ``test_two_process_fused_launches``);
- a stop signal to one rank inside a chunk stops every rank at the same
  chunk boundary;
- a rank that fails ends the world: the other rank raises within the
  collective timeout instead of hanging.
"""

import json
import shutil

import pytest
import torch

from tests import torch_parallel_worker as worker

TOL64 = 1e-10


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with the runs the test wrote into it
    once the test ends: nothing reads them afterwards, and their
    checkpoints take hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _check(rcs, logs):
    for rc, log in zip(rcs, logs):
        assert rc == 0, log[-4000:]


def test_collectives_match_one_process(tmp_path):
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    _check(*worker.run_world("collectives", outs, cwd=tmp_path))
    ranks = [json.loads(o.read_text()) for o in outs]
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["world"] == 2
        for key in ("bn_y", "bn_dx", "bn_dw", "bn_db", "bn_mean", "bn_var",
                    "ce_loss", "ce_grad", "cedt_loss", "cedt_grad"):
            assert r[key] <= TOL64, (r["rank"], key, r[key])
        assert r["bn_tracked"] == 1
        assert r["gather_block"] and r["gather_strided"]
        assert r["bytes"] and r["bytes_empty"]
        assert r["scalar"] == 7
        assert r["flag_any"] is True and r["flag_none"] is False


def _world_train64(tmp_path, *args):
    """Each rank's ``train64`` result in a world of two."""
    outs = [tmp_path / f"rank{r}.pt" for r in range(2)]
    _check(*worker.run_world("train64", outs, args=["2", *args],
                             cwd=tmp_path))
    r0, r1 = (torch.load(o) for o in outs)
    assert (r0["world"], r0["rank"], r1["rank"]) == (2, 0, 1)
    return r0, r1


def _same_as_one_process(r0, r1, ref):
    # both ranks hold the same losses and parameters, bit for bit
    assert r0["losses"] == r1["losses"]
    assert r0["state"].keys() == ref["state"].keys()
    for key, value in r0["state"].items():
        assert torch.equal(value, r1["state"][key]), key
    # and the run of one process at the global batch, within 1e-7 of each
    # tensor's largest magnitude (float64: the sums' order differs)
    assert r0["losses"] == pytest.approx(ref["losses"], rel=1e-7)
    moved = 0
    for key, want in ref["state"].items():
        got = r0["state"][key]
        if not want.is_floating_point():
            assert torch.equal(got, want), key
            continue
        scale = want.abs().max().clamp(min=1e-300)
        assert float((got - want).abs().max() / scale) <= 1e-7, key
        moved += "running_var" in key and not torch.equal(
            want, torch.ones_like(want))
    assert moved > 0        # the batch norms' statistics took the steps


def test_stage1_train_steps_match_one_process(tmp_path):
    r0, r1 = _world_train64(tmp_path)
    ref = worker.train64(4, tmp_path / "md")
    assert ref["world"] == 1 and len(ref["losses"]) == 2
    _same_as_one_process(r0, r1, ref)


def test_stage1_fused_steps_match_one_process(tmp_path):
    r0, r1 = _world_train64(tmp_path, "3", "2")
    ref = worker.train64(4, tmp_path / "md", steps=3, fuse=2)
    assert ref["world"] == 1 and len(ref["losses"]) == 3
    _same_as_one_process(r0, r1, ref)
    serial = worker.train64(4, tmp_path / "md1", steps=3)
    assert serial["losses"] == ref["losses"]
    for key, value in serial["state"].items():
        assert torch.equal(ref["state"][key], value), key


def test_stop_inside_a_chunk_stops_every_rank_at_its_boundary(tmp_path):
    """Baseline, two chunks of two steps a rank: rank 1 signals itself
    after the first step; both ranks finish that chunk and stop there."""
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    rcs, logs = worker.run_world(
        "entry", outs, args=["baseline", "train", "with", *worker.SMALL,
                             "data.train_n=16", "data.bs=2",
                             "tr.total_epochs=1", "net.backbone=vgg16",
                             "dev.fuse_steps=2",
                             f"g.model_dir={tmp_path / 'md'}"],
        env={"PEMP_TEST_SIGTERM": "1"}, cwd=tmp_path)
    _check(rcs, logs)
    r0, r1 = (json.loads(o.read_text()) for o in outs)
    assert r1["signalled"] and "signalled" not in r0
    for r in (r0, r1):
        assert r["preempted"] is True and r["test"] is None
        assert r["steps_run"] == 2          # the first chunk, whole
    assert "Graceful stop inside epoch 1" in logs[0]


def test_a_failing_rank_ends_the_world(tmp_path):
    outs = [tmp_path / f"rank{r}.txt" for r in range(2)]
    rcs, logs = worker.run_world("fail", outs, cwd=tmp_path)
    assert rcs[1] != 0 and "fails on purpose" in logs[1]
    # rank 0 was left in a collective: it raised, within the timeout
    assert rcs[0] != 0, logs[0][-4000:]
    assert "[killed: timeout]" not in logs[0]
    assert not outs[0].exists()
