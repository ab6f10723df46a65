"""The port's ``train`` entry on the CPU at 33x33 (SYNTH, cedt, f32).

It trains, records the run under ``g.model_dir/pemp_stage1/<id>/``,
writes ``ckpt.pt`` and ``bestckpt.pt`` and chains into a finite ``test``;
``resume=True exp_id=<id>`` continues from the saved epoch; a stop signal
ends the loop through a snapshot of the last completed epoch; ``-u``
records nothing; without ``dev.device=cpu`` and with no CUDA it raises.
"""

import math
import shutil
import os
import signal

import pytest
import torch

from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.core.trainer import Trainer
from pemp_tpu_torch.entry import pemp_stage1 as entry

SMALL = ["split=0", "data.dataset=SYNTH", "data.height=33", "data.width=33",
         "data.bs=2", "data.train_n=4", "data.test_bs=2", "data.test_n=4",
         "te.epochs=1", "loss=cedt", "data.num_workers=2",
         "dev.precision=f32"]


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with the checkpoints the test wrote
    into it once the test ends: nothing reads them afterwards, and at
    ResNet-50 width they take tens of MB a file."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _train(tmp_path, *extra):
    return entry.main(["train", "with", *SMALL, "dev.device=cpu",
                       f"g.model_dir={tmp_path}", *extra])


def test_train_records_a_run_and_chains_into_test(tmp_path):
    result = _train(tmp_path, "tr.total_epochs=1")
    train = result["train"]
    assert train["run_id"] == 1 and train["device"] == "cpu"
    assert len(train["losses"]) == 2
    assert all(math.isfinite(x) for x in train["losses"])
    run_dir = tmp_path / "pemp_stage1" / "1"
    assert {p.name for p in run_dir.iterdir()} == {ckpt_lib.CKPT,
                                                   ckpt_lib.BEST}
    payload = ckpt_lib.load(run_dir / ckpt_lib.CKPT)
    assert payload["epoch"] == 1
    assert payload["extra"]["best_epoch"] == 1
    assert math.isfinite(result["test"]["miou"])
    assert result["test"]["miou"] == pytest.approx(train["best_iou"])


def test_resume_continues_from_the_saved_epoch(tmp_path):
    _train(tmp_path, "tr.total_epochs=1")
    first = ckpt_lib.load(tmp_path / "pemp_stage1" / "1" / ckpt_lib.CKPT)
    result = _train(tmp_path, "tr.total_epochs=2", "resume=True", "exp_id=1")
    assert result["train"]["run_id"] == 1
    assert len(result["train"]["losses"]) == 2      # epoch 2 only
    payload = ckpt_lib.load(tmp_path / "pemp_stage1" / "1" / ckpt_lib.CKPT)
    assert payload["epoch"] == 2
    assert payload["optimizer"]["state"], "momentum buffers are saved"
    assert not torch.equal(payload["model"]["ctr"], first["model"]["ctr"])
    assert sorted(p.name for p in (tmp_path / "pemp_stage1").iterdir()) == ["1"]
    with pytest.raises(ValueError, match="exp_id"):
        _train(tmp_path, "resume=True")


def test_stop_signal_snapshots_the_completed_epoch(tmp_path, monkeypatch):
    step = Trainer.train_step

    def step_then_signal(self, batch):
        loss = step(self, batch)
        os.kill(os.getpid(), signal.SIGUSR1)
        return loss

    monkeypatch.setattr(Trainer, "train_step", step_then_signal)
    result = _train(tmp_path, "tr.total_epochs=2")
    assert result["train"]["preempted"] and "test" not in result
    payload = ckpt_lib.load(tmp_path / "pemp_stage1" / "1" / ckpt_lib.CKPT)
    assert payload["epoch"] == 0
    assert signal.getsignal(signal.SIGUSR1) is signal.SIG_DFL


def test_unobserved_run_records_nothing(tmp_path):
    result = entry.main(["train", "with", *SMALL, "dev.device=cpu",
                         f"g.model_dir={tmp_path}", "tr.total_epochs=1", "-u"])
    assert result["train"]["run_id"] is None and "test" not in result
    assert [p.name for p in tmp_path.iterdir()] == ["None"]


def test_train_without_cpu_request_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.main(["train", "with", *SMALL, f"g.model_dir={tmp_path}"])
