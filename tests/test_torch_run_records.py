"""Run records: the port's observed ``train`` and ``test`` runs write what
the JAX CLI writes (``pemp_tpu/config/cli.py``,
``pemp_tpu/utils/observers.py``).

The JAX Baseline entry (VGG16, the cheapest family to compile) and the
port's run one tiny CPU ``train`` (which chains into ``test``) and one
``test exp_id=1`` at the same overrides with ``g.mongodb=True``. Their
run folders hold the same files (the checkpoints by stem: ``.msgpack``
against ``.pt``), ``metrics.json`` the same scalars at the same steps,
the Mongo documents the same keys and the same kind of result line, and
``config.json`` the same keys (the renamed ones by ``CONFIG_RENAMED``)
but for those the port leaves out or adds (``CONFIG_ONLY_JAX``,
``CONFIG_ONLY_PORT``). Then the port
alone: ``-p``, a resume that keeps the metric history, and the statuses
of a failure, a ctrl-C and a signal-stopped training run.
"""

import json
import re
import runpy
import shutil
import sys
from pathlib import Path

import pytest

from pemp_tpu_torch.core import trainer as trainer_mod
from pemp_tpu_torch.entry import baseline as entry
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["split=0", "data.dataset=SYNTH", "data.height=33", "data.width=33",
         "data.bs=2", "data.train_n=4", "data.test_bs=2", "data.test_n=4",
         "te.epochs=1", "tr.total_epochs=1", "net.backbone=vgg16",
         "data.num_workers=2", "g.mongodb=True"]
PORT = ["dev.device=cpu", "dev.precision=f32"]
# config.json: the JAX package's device scope ``tpu`` is the port's
# ``dev``, where the keys of the world and the input path keep their names
# and the kernels' switch ``use_pallas`` is ``use_kernels``
# (``CONFIG_RENAMED``); the log file is not ported
CONFIG_RENAMED = {"tpu.mesh": "dev.mesh", "tpu.prefetch": "dev.prefetch",
                  "tpu.compact_wire": "dev.compact_wire",
                  "tpu.fuse_steps": "dev.fuse_steps",
                  "tpu.use_pallas": "dev.use_kernels"}
CONFIG_ONLY_JAX = {"tpu.platform", "tpu.precision", "g.log_file"}
CONFIG_ONLY_PORT = {"dev.device", "dev.precision"}
RESULT = re.compile(r"Loss: \d+\.\d{4}, mIoU: \d+\.\d{2}, bIoU: \d+\.\d{2}")


def docs(path):
    return [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]


def key_tree(obj):
    """The nested key structure of a JSON document (``config`` and the
    values left out)."""
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items() if k != "config"}
    return None


def names(run_dir):
    """A run folder's entries, the checkpoints by stem."""
    return {p.stem if p.suffix in (".msgpack", ".pt") else p.name
            for p in run_dir.iterdir()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``<root>/{jax,port}/baseline/{1,2}``: the train run (with its
    chained test) and a ``test exp_id=1`` run of each package."""
    root = tmp_path_factory.mktemp("records")
    jax_script = ROOT / "entry" / "baseline.py"
    jax_ex = runpy.run_path(str(jax_script), run_name="jax_entry")["ex"]
    for command in (["train"], ["test", "exp_id=1"]):
        # sys.argv[0] as each is started from a shell: the JAX CLI copies
        # it into sources/, and both name it in the Mongo run document
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", [str(jax_script)])
            jax_ex.run_commandline([command[0], "with", *SMALL,
                                    *command[1:],
                                    f"g.model_dir={root / 'jax'}"])
            mp.setattr(sys, "argv", [entry.__file__])
            entry.main([command[0], "with", *SMALL, *PORT, *command[1:],
                        f"g.model_dir={root / 'port'}"])
    yield root / "jax" / "baseline", root / "port" / "baseline"
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("run_id", ["1", "2"])
def test_run_folders_hold_the_jax_files(runs, run_id):
    jax_dir, port_dir = (d / run_id for d in runs)
    assert names(port_dir) == names(jax_dir)
    assert names(port_dir / "mongo") == names(jax_dir / "mongo")
    assert {"config.json", "sources", "mongo"} <= names(port_dir)
    assert [p.name for p in (port_dir / "sources").iterdir()] == [
        "baseline.py"]
    if run_id == "1":
        assert {"bestckpt", "ckpt", "metrics.json"} <= names(port_dir)


def test_metrics_and_mongo_documents_match_the_jax_records(runs):
    jax_dir, port_dir = (d / "1" for d in runs)
    jm = json.loads((jax_dir / "metrics.json").read_text())
    pm = json.loads((port_dir / "metrics.json").read_text())
    assert set(pm) == set(jm) == {"train_loss", "val_loss", "val_mIoU",
                                  "val_bIoU"}
    for name, points in pm.items():
        assert [s for s, _ in points] == [s for s, _ in jm[name]] == [1]
    for run_id in ("1", "2"):
        jax_dir, port_dir = (d / run_id for d in runs)
        (jr,), (pr,) = (docs(d / "mongo" / "runs.json")
                        for d in (jax_dir, port_dir))
        assert key_tree(pr) == key_tree(jr)
        assert pr["status"] == jr["status"] == "COMPLETED"
        assert RESULT.fullmatch(pr["result"]) and RESULT.fullmatch(
            jr["result"])
        assert (pr["command"], pr["experiment"]["mainfile"]) == (
            jr["command"], jr["experiment"]["mainfile"])
        assert set(pr["config"]) == set(json.loads(
            (port_dir / "config.json").read_text()))
    jmet, pmet = (docs(d / "1" / "mongo" / "metrics.json") for d in runs)
    assert [key_tree(d) for d in pmet] == [key_tree(d) for d in jmet]
    assert {d["name"]: d["steps"] for d in pmet} == {
        d["name"]: d["steps"] for d in jmet}


def test_config_json_has_the_jax_keys(runs):
    jax_dir, port_dir = (d / "1" for d in runs)
    jc = json.loads((jax_dir / "config.json").read_text())
    jc = {CONFIG_RENAMED.get(k, k): v for k, v in jc.items()}
    pc = json.loads((port_dir / "config.json").read_text())
    assert set(jc) - set(pc) == CONFIG_ONLY_JAX
    assert set(pc) - set(jc) == CONFIG_ONLY_PORT
    for key in ("split", "tr.total_epochs", "data.height", "net.backbone",
                "g.mongodb", "data.mean", "p.cls", *CONFIG_RENAMED.values()):
        assert pc[key] == jc[key], key


def test_print_config_flag_prints_then_runs(tmp_path, capsys):
    result = entry.main(["test", "with", *SMALL, *PORT, "-p",
                         f"g.model_dir={tmp_path}"])
    out = capsys.readouterr().out
    assert "Configuration:" in out and "  split = 0" in out
    assert 0.0 <= result["miou"] <= 1.0
    assert (tmp_path / "baseline" / "1" / "config.json").exists()
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_resume_keeps_the_metric_history(tmp_path):
    md = f"g.model_dir={tmp_path}"
    entry.main(["train", "with", *SMALL, *PORT, md])
    entry.main(["train", "with", *SMALL, *PORT, md, "resume=True",
                "exp_id=1", "tr.total_epochs=2"])
    run = tmp_path / "baseline" / "1"
    assert (run / "config.resume.json").exists()
    assert json.loads((run / "config.json").read_text())[
        "tr.total_epochs"] == "1"
    metrics = json.loads((run / "metrics.json").read_text())
    assert [s for s, _ in metrics["val_mIoU"]] == [1, 2]
    mongo = {d["name"]: d for d in docs(run / "mongo" / "metrics.json")}
    assert mongo["train_loss"]["steps"] == [1, 2]
    assert sorted(p.name for p in (tmp_path / "baseline").iterdir()) == ["1"]
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_statuses_of_a_failure_a_ctrl_c_and_a_stopped_run(tmp_path,
                                                          monkeypatch):
    md = f"g.model_dir={tmp_path}"
    with pytest.raises(FileNotFoundError):        # no PASCAL tree there
        entry.main(["test", "with", *SMALL, *PORT, md, "data.dataset=PASCAL",
                    f"data.base_dir={tmp_path / 'missing'}"])

    def interrupted(cfg, device):
        raise KeyboardInterrupt

    monkeypatch.setattr(entry, "build_model", interrupted)
    with pytest.raises(KeyboardInterrupt):
        entry.main(["test", "with", *SMALL, *PORT, md])
    monkeypatch.undo()

    def signalled(self):            # SIGTERM arrived before the first step
        self.requested = True
        return self

    monkeypatch.setattr(trainer_mod.GracefulStop, "install", signalled)
    result = entry.main(["train", "with", *SMALL, *PORT, md])
    assert result["train"]["preempted"] and "test" not in result
    status = {p.name: docs(p / "mongo" / "runs.json")[0]
              for p in (tmp_path / "baseline").iterdir()}
    assert {k: (d["status"], d["command"]) for k, d in status.items()} == {
        "1": ("FAILED", "test"), "2": ("INTERRUPTED", "test"),
        "3": ("INTERRUPTED", "train")}
    assert status["3"]["result"] == "PREEMPTED"
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_unobserved_runs_record_nothing(tmp_path):
    entry.main(["test", "with", *SMALL, *PORT, f"g.model_dir={tmp_path}",
                "-u"])
    assert not (tmp_path / "baseline").exists()
