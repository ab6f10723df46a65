"""PEMP stage 2, PANet, RPMMs and PFENet in a world of two processes over
gloo on the CPU (``tests/torch_parallel_worker.py``, each process with a
timeout), held against one process at the global batch:

- two train steps each, so that a trainable parameter left without a
  gradient would trip ``DistributedDataParallel`` at its second step
  (stage 2's frozen stage 1 and PFENet's gradient-free trunk are not
  DDP's);
- stage 2 reads its stage-1 snapshot on rank 0 and broadcasts it;
- rank 0 alone records, both ranks take the chained ``test`` of rank 0's
  ``bestckpt.pt`` and end with the same metrics; the losses and metrics
  equal one process at twice the batch within 1e-9, at float64
  (``torch_parallel_worker.float64`` says why not float32), the trunks
  one block a stage.

One world trains the four families in turn (one start-up for all).
"""

import json
import shutil

import pytest
import torch

from pemp_tpu_torch.entry import pemp_stage1
from tests import torch_parallel_worker as worker
from tests.test_torch_parallel_entry import (  # noqa: F401
    _metrics, _same_metrics, one_thread,
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the stage-1 snapshot, the root of the runs, each rank's results)
    of one world that trains every family; each case removes its family's
    runs (hundreds of MB of checkpoints each) once it has read them, and
    what is left goes once the module's tests end."""
    root = tmp_path_factory.mktemp("families")
    cfg = pemp_stage1.ex.assemble("test", {"split": "0", "dev.device": "cpu"})
    s1 = root / "stage1.pt"
    with worker.shallow():
        torch.save(pemp_stage1.build_model(cfg, torch.device("cpu"))
                   .state_dict(), s1)
    outs = [root / f"rank{r}.json" for r in range(2)]
    rcs, logs = worker.run_world("families", outs,
                                 args=[str(s1), str(root / "multi")], cwd=root)
    for rc, log in zip(rcs, logs):
        assert rc == 0, log[-4000:]
    yield s1, root, [json.loads(o.read_text()) for o in outs]
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("name", list(worker.FAMILIES))
def test_family_world_matches_one_process(runs, name):
    import importlib

    s1, root, ranks = runs
    multi, single = root / "multi" / name, root / "single" / name
    try:
        r0, r1 = (r[name] for r in ranks)
        assert (r0["world"], r0["rank"], r1["world"], r1["rank"]) \
            == (2, 0, 2, 1)
        assert r0["run_id"] == 1 and r1["run_id"] is None
        assert sorted(p.name for p in (multi / name).iterdir()) == ["1"]
        # the world's run is read: its checkpoints go before the single
        # process writes its own (F7: the module's peak on disk)
        shutil.rmtree(multi)
        assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
        assert _metrics(r0["test"]) == _metrics(r1["test"])
        mod = importlib.import_module(f"pemp_tpu_torch.entry.{name}")
        with worker.float64(mod):
            result = mod.main(worker.family_args(name, s1, 4, single))
        assert r0["losses"] == pytest.approx(result["train"]["losses"],
                                             rel=1e-9)
        _same_metrics(r0["test"], result["test"], rel=1e-9)
    finally:
        shutil.rmtree(multi, ignore_errors=True)
        shutil.rmtree(single, ignore_errors=True)
