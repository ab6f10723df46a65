"""The port's reference-checkpoint converters
(``pemp_tpu_torch/tools/{convert,export}_reference_ckpt.py``) on the CPU:

- a seeded reference-layout ``.pth`` goes ``.pth`` -> ``.pt`` -> ``.pth``
  through both command lines bit for bit, for every family at the JAX
  round-trip test's backbones (``tests/test_export_roundtrip.py``
  ``CASES``), with the port's models only; the ``.pt`` is the trainer's
  checkpoint format, which ``load_weights`` takes;
- on the JAX package's weights (``tools.convert_reference_ckpt.
  build_init_trees``, every leaf re-drawn as the JAX round-trip test
  does), the port's export of ``state_dict_from_jax(params, stats)``
  equals ``tools.export_reference_ckpt.export_trained`` in keys and
  values for stage 1 (ResNet-50) and stage 2 (ResNetCM); for stage 2
  with VGG16CM, which ``export_trained`` refuses, the export holds
  ``state_dict_from_jax``'s layout; a ``.msgpack`` written by
  ``pemp_tpu.core.checkpoint`` exports to the same ``.pth`` as the
  weights it holds.

Each test removes what it writes (a ResNet-50 file is ~50 MB, PFENet's
~140 MB).
"""

import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parents[1]))

from pemp_tpu_torch.core import checkpoint as port_ckpt  # noqa: E402
from pemp_tpu_torch.tools import convert_reference_ckpt as convert  # noqa: E402
from pemp_tpu_torch.tools import export_reference_ckpt as export  # noqa: E402
from pemp_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402
from tests import test_export_roundtrip as jax_roundtrip  # noqa: E402
from tools.convert_reference_ckpt import build_init_trees  # noqa: E402
from tools.export_reference_ckpt import export_trained  # noqa: E402


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with the checkpoints written into it
    once the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def seeded_reference_sd(name, backbone, seed=0):
    """A reference-layout ``state_dict`` of ``name`` with every tensor
    re-drawn from ``seed`` (running variances positive)."""
    gen = torch.Generator().manual_seed(seed)
    sd = export.reference_sd(convert.build_model(name, backbone, 1))
    out = {}
    for k, v in sd.items():
        r = torch.randn(v.shape, generator=gen)
        out[k] = r.abs() + 0.5 if k.endswith("running_var") else r
    return out


@pytest.mark.parametrize("name,backbone", jax_roundtrip.CASES)
def test_pth_to_pt_to_pth_is_bit_exact(name, backbone, tmp_path):
    sd = seeded_reference_sd(name, backbone)
    ref, pt, back = (tmp_path / f for f in ("ref.pth", "conv.pt",
                                            "back.pth"))
    torch.save(sd, ref)
    args = ["--model", name, "--backbone", backbone]
    convert.main([*args, "--ckpt", str(ref), "--out", str(pt)])
    # the trainer's checkpoint format (the exporter reads it with
    # load_weights, as test and visualize do)
    assert set(port_ckpt.load(pt)) == {"model", "optimizer", "epoch",
                                       "extra"}
    export.main([*args, "--ckpt", str(pt), "--out", str(back)])
    got = torch.load(back, map_location="cpu", weights_only=True)
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_a_mismatched_file_is_refused(tmp_path):
    sd = seeded_reference_sd("pemp_stage1", "resnet50")
    sd.pop("ctr")
    torch.save(sd, tmp_path / "ref.pth")
    with pytest.raises(RuntimeError, match="ctr"):
        convert.main(["--model", "pemp_stage1", "--ckpt",
                      str(tmp_path / "ref.pth"), "--out",
                      str(tmp_path / "x.pt")])
    assert not (tmp_path / "x.pt").exists()


def jax_trees(name, backbone):
    """The JAX package's init trees of ``name``, every leaf re-drawn as
    ``tests/test_export_roundtrip.py`` does."""
    _, params, stats = build_init_trees(name, backbone, shot=1, seed=0)
    rng = np.random.default_rng(7)
    draw = (lambda a: rng.standard_normal(a.shape).astype(a.dtype))
    return (jax.tree_util.tree_map(draw, params),
            jax.tree_util.tree_map(draw, stats))


def port_export(name, backbone, params, stats):
    model = convert.convert(state_dict_from_jax(params, stats), name,
                            backbone, 1)
    return export.reference_sd(model)


def assert_same_sd(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize("name,backbone", [("pemp_stage1", "resnet50"),
                                           ("pemp_stage2", "resnet50")])
def test_export_equals_the_jax_exporter(name, backbone, tmp_path):
    params, stats = jax_trees(name, backbone)
    want = export_trained(name, backbone, params, stats)
    assert_same_sd(port_export(name, backbone, params, stats), want)
    if name == "pemp_stage1":
        # the JAX package's .msgpack of the same weights exports alike
        from pemp_tpu.core import checkpoint as jax_ckpt
        path = tmp_path / "bestckpt.msgpack"
        jax_ckpt.save(path, {"params": params, "batch_stats": stats})
        out = tmp_path / "out.pth"
        export.main(["--model", name, "--backbone", backbone, "--ckpt",
                     str(path), "--out", str(out)])
        assert_same_sd(torch.load(out, weights_only=True), want)


def test_vgg16cm_stage2_exports_the_port_layout():
    params, stats = jax_trees("pemp_stage2", "vgg16")
    with pytest.raises(ValueError, match="vgg16"):
        export_trained("pemp_stage2", "vgg16", params, stats)
    sd = state_dict_from_jax(params, stats)
    got = port_export("pemp_stage2", "vgg16", params, stats)
    assert set(got) == set(sd)          # VGG16CM holds no batch norm
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    assert got["encoder.backbone.features.0.weight"].shape[1] == 4
    assert {f"encoder.backbone.linear{k}.weight" for k in range(1, 5)} <= \
        set(got)
