"""The port's entries in a world of two processes over gloo on the CPU
(``tests/torch_parallel_worker.py``, each process with a timeout), held
against one process, as the JAX package's ``tests/test_distributed_2proc.py``
holds its own:

- Baseline ``train`` (chained into ``test``): rank 0 alone records (one
  run folder, rank 1's run id None); both ranks end with the same test
  metrics; the losses and metrics equal one process at the global batch;
- a SIGTERM to rank 1 alone stops both ranks after the same step, with a
  resumable snapshot; the resumed run ends on both ranks alike.
"""

import json
import shutil

import pytest
import torch

from pemp_tpu_torch.entry import baseline
from tests import torch_parallel_worker as worker

TRAIN = ["data.train_n=8", "tr.total_epochs=1", "net.backbone=vgg16"]
METRICS = ("loss", "miou", "biou")


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


def _world(tmp_path, module, args, env=None):
    tmp_path.mkdir(exist_ok=True)
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    rcs, logs = worker.run_world(
        "entry", outs, args=[module, "train", "with", *worker.SMALL, *args],
        env=env, cwd=tmp_path)
    for rc, log in zip(rcs, logs):
        assert rc == 0, log[-4000:]
    return [json.loads(o.read_text()) for o in outs], logs


def _single(entry, args):
    result = entry.main(["train", "with", *worker.SMALL, *args])
    return result["train"]["losses"], result["test"]


def _metrics(test):
    return {key: test[key] for key in METRICS}


def _same_metrics(a, b, rel=1e-4):
    """Float32 runs: the world sums each gradient in another order than
    one process (measured: 7.1e-6 rel on the Baseline test loss)."""
    for key in METRICS:
        assert a[key] == pytest.approx(b[key], rel=rel, abs=1e-9), key


def test_baseline_world_records_on_rank0_and_matches_one_process(tmp_path):
    multi, single = tmp_path / "multi", tmp_path / "single"
    (r0, r1), _ = _world(tmp_path, "baseline",
                         [*TRAIN, "data.bs=2", f"g.model_dir={multi}"])
    assert (r0["world"], r0["rank"], r1["world"], r1["rank"]) == (2, 0, 2, 1)
    assert r0["run_id"] == 1 and r1["run_id"] is None
    assert sorted(p.name for p in (multi / "baseline").iterdir()) == ["1"]
    assert {p.name for p in (multi / "baseline" / "1").iterdir()} >= {
        "ckpt.pt", "bestckpt.pt", "config.json", "metrics.json"}
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    assert _metrics(r0["test"]) == _metrics(r1["test"])
    # the world's run is read: its checkpoints go before the single
    # process writes its own (F7: the test's peak on disk)
    shutil.rmtree(multi)
    losses, test = _single(baseline, [*TRAIN, "data.bs=4",
                                      f"g.model_dir={single}"])
    assert r0["losses"] == pytest.approx(losses, rel=1e-5)
    _same_metrics(r0["test"], test)


def test_sigterm_on_one_rank_stops_every_rank_and_resumes(tmp_path):
    args = [*TRAIN, "data.bs=2", f"g.model_dir={tmp_path / 'md'}"]
    (r0, r1), logs = _world(tmp_path / "first", "baseline", args,
                            env={"PEMP_TEST_SIGTERM": "1"})
    assert r1["signalled"] and "signalled" not in r0
    for r in (r0, r1):
        # both stopped after the same (first) step of epoch 1, untested
        assert r["preempted"] is True
        assert len(r["losses"]) == 0 and r["test"] is None
    assert "Graceful stop inside epoch 1" in logs[0]
    assert r0["run_id"] == 1
    # a new world resumes the run from rank 0's snapshot and tests it
    (r0, r1), _ = _world(tmp_path / "again", "baseline",
                         [*args, "resume=True", "exp_id=1"])
    for r in (r0, r1):
        assert r["preempted"] is False and len(r["losses"]) == 2
    assert r0["losses"] == r1["losses"]
    assert _metrics(r0["test"]) == _metrics(r1["test"])
    assert r0["run_id"] == 1
