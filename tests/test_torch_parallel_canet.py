"""CaNet in a world of two processes over gloo on the CPU
(``tests/torch_parallel_worker.py``, each process with a timeout), held
against one process as the JAX package's
``tests/test_distributed_2proc.py::test_two_process_canet_pipeline`` holds
its own: every rank reads the whole stream and computes its rows of rank
0's batch, and the gathered logits feed every rank's history store, which
the second epoch reads. Both ranks end alike, and like one process at the
same batch.
"""

import shutil

import pytest

from pemp_tpu_torch.entry import canet
from tests.test_torch_parallel_entry import (  # noqa: F401
    _metrics, _same_metrics, _single, _world, one_thread,
)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with the runs the test wrote into it
    once the test ends: nothing reads them afterwards, and their
    checkpoints take hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_canet_world_matches_one_process(tmp_path):
    args = ["data.train_n=8", "tr.total_epochs=2", "data.bs=2"]
    (r0, r1), _ = _world(tmp_path, "canet",
                         [*args, f"g.model_dir={tmp_path / 'multi'}"])
    assert (r0["world"], r1["world"]) == (2, 2)
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 8
    assert _metrics(r0["test"]) == _metrics(r1["test"])
    # the world's runs are read: their checkpoints go before the single
    # process writes its own (F7: the test's peak on disk)
    shutil.rmtree(tmp_path / "multi")
    losses, test = _single(canet, [*args,
                                   f"g.model_dir={tmp_path / 'single'}"])
    assert r0["losses"] == pytest.approx(losses, rel=1e-5)
    _same_metrics(r0["test"], test)
