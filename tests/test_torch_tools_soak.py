"""The SIGTERM / resume drill (``pemp_tpu_torch/tools/soak_run.py``), the
counterpart of ``tools/soak_run.sh``: its summary on hand-written run
records (a clean run, a duplicated epoch, a missing final test line),
where the stop landed from the trainer's log line, the waits' limits
(a phase that outlives them is killed, a non-zero exit), and one whole drill
on the CPU through the ``cpu`` preset at 33x33 SYNTH (3 epochs, SIGTERM
once epoch 1 is recorded): both phases exit 0, three epochs recorded
once each, the chained test's line in the log, the run's records kept.
"""

import json
import shutil
import subprocess
import time

import pytest

from pemp_tpu_torch.tools import soak_run

FINAL = ("2026-01-01 00:00:00,000 INFO pemp_tpu_torch.pemp_stage1: "
         "Loss: 0.6818, mIoU: 23.07, bIoU: 45.48\n")
STOP = ("INFO pemp_tpu_torch.pemp_stage1: Graceful stop inside epoch 2 "
        "after 16 steps (fuse_steps 8) - snapshot records completed epoch "
        "1; resume with `train with resume=True exp_id=<id>`\n")


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with the runs written into it once
    the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def write_run(root, train_loss, miou, log_text, run_id=1):
    run = root / "pemp_stage1" / str(run_id)
    run.mkdir(parents=True)
    (run / "metrics.json").write_text(json.dumps(
        {"train_loss": train_loss, "val_mIoU": miou}))
    log = root / "soak_train.log"
    log.write_text(log_text)
    return log


def test_summary_of_a_clean_run(tmp_path):
    log = write_run(tmp_path, [[1, 0.9], [2, 0.7], [3, 0.5]],
                    [[1, 0.1], [2, 0.3], [3, 0.2]], STOP + FINAL)
    assert soak_run.summarize(tmp_path, log) == {
        "epochs_recorded": 3, "duplicate_epochs": [], "first_loss": 0.9,
        "last_loss": 0.5, "best_mIoU": 0.3, "watchdog_events": 0,
        "wedge_retries": 0, "final_test": True}
    assert soak_run.epochs_done(tmp_path) == 3


def test_summary_of_a_duplicated_epoch(tmp_path):
    log = write_run(tmp_path, [[1, 0.9], [2, 0.8], [2, 0.7], [3, 0.5]],
                    [[1, 0.1]], FINAL)
    s = soak_run.summarize(tmp_path, log)
    assert s["duplicate_epochs"] == [2] and s["epochs_recorded"] == 4


def test_summary_without_the_final_test_line(tmp_path):
    log = write_run(tmp_path, [[1, 0.9]], [], "Epoch: 1/3 | WATCHDOG\n")
    s = soak_run.summarize(tmp_path, log)
    assert s["final_test"] is False and s["best_mIoU"] is None
    assert s["watchdog_events"] == 1


def test_stop_point_reads_the_trainer_line():
    assert soak_run.stop_point(STOP) == {"epoch": 2, "steps": 16,
                                         "fuse_steps": 8, "chunks": 2}
    assert soak_run.stop_point(FINAL) is None


def test_wait_limits_follow_the_pace_and_kill_a_hung_phase(tmp_path):
    # 30 s for 1 of 3 epochs: a stop may take 4 epochs' pace, a resume
    # 4x the pace for the 2 epochs left, the replayed one and the test
    assert soak_run.limits(30.0, 1, 3) == (120.0, 480.0)
    assert soak_run.limits(1.0, 1, 3) == (soak_run.FLOOR_S,
                                          soak_run.FLOOR_S)
    assert soak_run.total_epochs(tmp_path) == 0
    run = tmp_path / "pemp_stage1" / "1"
    run.mkdir(parents=True)
    (run / "metrics.json").write_text("{}")
    (run / "config.json").write_text(json.dumps({"tr.total_epochs": "3"}))
    assert soak_run.total_epochs(tmp_path) == 3
    proc = subprocess.Popen(["sleep", "30"])
    t0 = time.monotonic()
    assert soak_run.waited(proc, 0.2) != 0
    assert time.monotonic() - t0 < 10


def test_drill_on_the_cpu(tmp_path, monkeypatch):
    # one torch thread a phase: under the suite's workers a process with
    # a thread a core runs many times slower than alone
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = soak_run.drill(tmp_path, 8, 1, 0.2, "cpu", overrides=[
        "tr.total_epochs=3", "data.height=33", "data.width=33",
        "data.bs=2", "data.test_bs=2", "data.test_n=4", "te.epochs=1",
        "data.num_workers=1", "dev.precision=f32"])
    assert (out["rc1"], out["rc2"]) == (0, 0)
    assert out["sigterm_at_epoch"] == 1
    assert out["epochs_recorded"] == 3 and out["duplicate_epochs"] == []
    assert out["final_test"] is True
    assert out["stop"]["epoch"] == 2 and out["stop"]["fuse_steps"] == 1
    run = tmp_path / "pemp_stage1" / "1"
    assert {"ckpt.pt", "bestckpt.pt", "config.json", "metrics.json",
            "mongo"} <= {p.name for p in run.iterdir()}
    assert sorted(p.name for p in (run / "mongo").iterdir()) == [
        "metrics.json", "runs.json"]
