"""The port's launch presets (``pemp_tpu_torch/scripts/<family>.sh``)
against the JAX package's (``scripts/<family>.sh``): the same ``with``
arguments for all seven families, parsed from both texts; the device
arguments (``cuda`` adds ``dev.fuse_steps=8``, the counterpart of
``tpu.fuse_steps=8``; ``cpu`` adds ``dev.device=cpu``; ``cpu<N>`` runs N
processes under torchrun); one ``print_config`` through the script; and
``train`` with the device defaulted refuses to run without CUDA.
"""

import os
import re
import shlex
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("baseline", "canet", "panet", "pemp_stage1", "pemp_stage2",
            "pfenet", "rpmms")
PORT = ROOT / "pemp_tpu_torch" / "scripts"


def jax_with_args(family):
    """The ``with`` arguments of ``scripts/<family>.sh`` (the text between
    ``ARGS=' with`` and its ``'$FUSE'``)."""
    text = (ROOT / "scripts" / f"{family}.sh").read_text()
    m = re.search(r"ARGS=' with\n(.*?)'\$FUSE'", text, re.S)
    return m.group(1).split()


def port_with_args(family):
    """The ``PRESET`` of ``pemp_tpu_torch/scripts/<family>.sh``."""
    text = (PORT / f"{family}.sh").read_text()
    m = re.search(r'^PRESET="(.*?)"', text, re.S | re.M)
    return m.group(1).split()


def dry_run(family, *argv):
    """The command the preset would exec: the script run with a stand-in
    ``python`` that prints its arguments."""
    env = dict(os.environ, PYTHON="echo")
    out = subprocess.run(["bash", str(PORT / f"{family}.sh"), *argv],
                         env=env, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    return shlex.split(out.stdout)


@pytest.mark.parametrize("family", FAMILIES)
def test_preset_with_arguments_equal_the_jax_scripts(family):
    want = jax_with_args(family)
    assert want and want[0] == f"tag={family}"
    assert port_with_args(family) == want


@pytest.mark.parametrize("family", FAMILIES)
def test_device_arguments(family):
    preset = jax_with_args(family)
    entry = ["-m", f"pemp_tpu_torch.entry.{family}", "train", "with"]
    assert dry_run(family, "train") == entry + preset + ["dev.fuse_steps=8"]
    assert dry_run(family, "train", "cpu", "tr.lr=0.5") == \
        entry + preset + ["dev.device=cpu", "tr.lr=0.5"]
    assert dry_run(family, "test", "cpu4") == [
        "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=4",
        "-m", f"pemp_tpu_torch.entry.{family}", "test", "with", *preset,
        "dev.device=cpu", "dev.mesh=4"]
    assert dry_run(family, "help") == ["-m", f"pemp_tpu_torch.entry.{family}",
                                       "help"]


def test_print_config_through_the_script():
    out = subprocess.run(
        ["bash", str(PORT / "pemp_stage1.sh"), "print_config", "cpu",
         "tr.total_epochs=7"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHON=sys.executable))
    assert out.returncode == 0, out.stderr
    cfg = dict(re.findall(r"^\s+(\S+) = (.*)$", out.stdout, re.M))
    assert cfg["tag"] == "'pemp_stage1'"
    assert cfg["tr.total_epochs"] == "7"        # a later k=v wins
    assert cfg["loss"] == "'cedt'"
    assert cfg["net.backbone"] == "'resnet50'"
    assert cfg["dev.device"] == "'cpu'" and cfg["dev.fuse_steps"] == "1"


def test_train_on_the_default_device_needs_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    out = subprocess.run(
        ["bash", str(PORT / "pemp_stage1.sh"), "train"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHON=sys.executable))
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


def test_unknown_device_is_refused():
    out = subprocess.run(["bash", str(PORT / "pemp_stage1.sh"), "train",
                          "tpu"], capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "unknown device 'tpu'" in out.stderr
