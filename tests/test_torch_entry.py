"""The port's ``test`` entry, config and SYNTH data on the CPU.

The entry runs end to end on SYNTH at 33x33 with ``dev.device=cpu`` and
reports a finite mIoU; without ``dev.device=cpu`` and with no CUDA it
raises instead of falling back. The SYNTH episodes equal the JAX
package's for the same seeds (exact).
"""

import math
import shutil

import numpy as np
import pytest
import torch

from pemp_tpu.config.base import Config as JaxConfig
from pemp_tpu.data.synthetic import SyntheticDataset as JaxSynth
from pemp_tpu_torch.config import apply_overrides
from pemp_tpu_torch.data import datasets
from pemp_tpu_torch.device import resolve_device
from pemp_tpu_torch.entry import pemp_stage1 as entry

SMALL = ["split=0", "data.dataset=SYNTH", "data.height=33", "data.width=33",
         "data.test_bs=2", "data.test_n=4", "te.epochs=2", "data.num_workers=2"]


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with the checkpoints the test wrote
    into it once the test ends: nothing reads them afterwards, and at
    ResNet-50 width they take tens of MB a file."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_entry_test_runs_on_cpu(tmp_path, precision):
    result = entry.main(["test", "with", *SMALL, "dev.device=cpu",
                         f"dev.precision={precision}",
                         f"g.model_dir={tmp_path}"])
    assert result["device"] == "cpu"
    for key in ("loss", "miou", "biou"):
        assert math.isfinite(result[key]), result
    assert 0.0 <= result["miou"] <= 1.0 and result["fps"] > 0


def test_entry_loads_a_checkpoint(tmp_path):
    cfg = entry.ex.assemble("test", dict(a.split("=", 1) for a in SMALL))
    cfg.dev.device, cfg.dev.precision, cfg.seed = "cpu", "f32", 7
    model = entry.build_model(cfg, torch.device("cpu"))
    torch.save(model.state_dict(), tmp_path / "w.pt")
    cfg.ckpt, cfg.seed = str(tmp_path / "w.pt"), 8
    loaded = entry.build_model(cfg, torch.device("cpu"))
    for (k, a), b in zip(model.state_dict().items(),
                         loaded.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    cfg.ckpt = str(tmp_path / "missing.pt")
    with pytest.raises(FileNotFoundError):
        entry.build_model(cfg, torch.device("cpu"))


def test_entry_without_cpu_request_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.main(["test", "with", *SMALL, f"g.model_dir={tmp_path}"])
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("argv", [["train", "with", "split=0", "resume=True"],
                                  ["visualize", "with", "p.bogus=1"],
                                  ["bogus"], ["test", "with", "net.bogus=1"],
                                  ["test", "with", "data.dataset=SYNTH"]])
def test_entry_refuses_what_is_not_there(argv):
    with pytest.raises((SystemExit, KeyError, ValueError)):
        entry.main(argv)


def test_overrides_parse_like_the_jax_cli():
    cfg = entry.ex.assemble("test", {"split": "1", "te.epochs": "3",
                                     "data.cache": "off", "seed": "2.0",
                                     "dev.precision": "f32"})
    assert (cfg.split, cfg.te.epochs, cfg.data.cache, cfg.seed,
            cfg.dev.precision) == (1, 3, False, 2, "f32")
    with pytest.raises(ValueError):
        apply_overrides(cfg, {"data.cache": "maybe"})


@pytest.mark.parametrize("shot", [1, 5])
def test_synth_episodes_equal_the_jax_package(shot):
    overrides = {"data.dataset": "SYNTH", "data.height": "41",
                 "data.width": "37", "data.test_n": "6", "shot": str(shot),
                 "split": "2"}
    cfg = entry.ex.assemble("test", overrides)
    jcfg = JaxConfig()
    from pemp_tpu.config.base import apply_overrides as jax_overrides
    jax_overrides(jcfg, overrides)
    ours, _, n_classes = datasets.load(cfg)
    ref = JaxSynth(jcfg, False, 2, shot, 1)
    assert n_classes == ref.num_classes
    for ds in (ours, ref):
        ds.reset_sampler()
        ds.sample_tasks()
    for i in range(len(ours)):
        a, b = ours.get_episode(i), ref.get_episode(i)
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
