"""Helpers the serving-export tests share (no tests of its own, one fixture): the JAX
package's serving function and the port's artifact of one family at 33x33
(41x41 for PFENet), with the JAX trees carried across by
``state_dict_from_jax``, seeded episodes, and the exported program saved
and loaded back from ``tmp_path``, which a test removes when it ends.
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parents[1]))

from pemp_tpu_torch.models.baseline import Baseline  # noqa: E402
from pemp_tpu_torch.models.canet import CaNet  # noqa: E402
from pemp_tpu_torch.models.panet import PANet  # noqa: E402
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1  # noqa: E402
from pemp_tpu_torch.models.pemp_stage2 import PEMPStage2  # noqa: E402
from pemp_tpu_torch.models.pfenet import PFENet  # noqa: E402
from pemp_tpu_torch.models.rpmms import RPMMs  # noqa: E402
from pemp_tpu_torch.tools import export_serving as X  # noqa: E402
from pemp_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402
from tools.convert_reference_ckpt import build_init_trees  # noqa: E402
from tools.export_serving import (  # noqa: E402
    build_cascade_serving_fn as jax_cascade_fn,
    build_serving_fn as jax_serving_fn,
)

RTOL, ATOL = 1e-3, 2e-4          # tests/test_torch_model_parity.py
BACKBONE = {"baseline": "vgg16", "pemp_stage1": "resnet50",
            "pemp_stage2": "resnet50", "panet": "vgg16", "canet": "resnet50",
            "rpmms": "resnet50", "pfenet": "resnet50v2"}
PEMP = ("pemp_stage1", "pemp_stage2", "cascade")
MPM_OPS = ("pemp.mpm_assign.default", "pemp.mpm_match.default")


def hw_of(family):
    return 41 if family == "pfenet" else 33     # pfenet: (hw-1) % 8 == 0


def port_model(family, backbone):
    return {"baseline": lambda: Baseline(backbone=backbone),
            "pemp_stage1": lambda: PEMPStage1(backbone=backbone),
            "pemp_stage2": lambda: PEMPStage2(backbone=backbone),
            "panet": lambda: PANet(backbone=backbone),
            "canet": CaNet, "rpmms": RPMMs,
            "pfenet": lambda: PFENet(shot=1)}[family]()


def carried(family, backbone=None):
    """(JAX model, its variables, the port's model with them, eval mode)."""
    backbone = backbone or BACKBONE[family]
    model, params, stats = build_init_trees(family, backbone, shot=1)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    port = port_model(family, backbone)
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return model, variables, port.eval()


def episode(family, b, seed, hw=None):
    """Seeded inputs of the artifact at batch b: gaussian images, a {0,1}
    fg/bg support mask, stage 2's {0,1} prior, CaNet's history softmax."""
    hw = hw or hw_of(family)
    rng = np.random.RandomState(seed)
    shapes = X.input_shapes(family, b, 1, 1, hw)
    arrays = [rng.randn(*s).astype(np.float32) for s in shapes]
    fg = (rng.rand(b, 1, hw, hw, 1) > 0.5).astype(np.float32)
    arrays[1] = np.concatenate([fg, 1 - fg], -1)
    if family == "pemp_stage2":
        arrays[3] = (rng.rand(*shapes[3]) > 0.5).astype(np.float32)
    elif family == "canet":
        e = np.exp(arrays[3])
        arrays[3] = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return arrays


def roundtrip(serve, inputs, dyn, tmp_path, name):
    """Export, save, load back: the loaded program and the saved file."""
    exported = X.export_serving(serve, inputs, dyn)
    path = tmp_path / f"{name}.pt2"
    X.save_serving(exported, path, {"model": name, "precision": "f32"})
    return X.load_serving(path), exported, path


def mpm_nodes(exported):
    return sorted(str(n.target) for n in exported.graph.nodes
                  if str(n.target).startswith("pemp."))


def run_port(fn, arrays):
    with torch.no_grad():
        return fn(*[torch.from_numpy(a) for a in arrays]).numpy()


def run_jax(serve, arrays):
    with jax.default_matmul_precision("highest"):
        return np.asarray(serve(*[jnp.asarray(a) for a in arrays]))


def jax_family_fn(model, variables, family):
    """The JAX package's jitted serving function (any batch)."""
    serve, _ = jax_serving_fn(family, model, variables, 1, 1, 1,
                              hw_of(family))
    return serve


def jax_cascade(s1, v1, s2, v2, hw):
    serve, _ = jax_cascade_fn(s1, v1, s2, v2, 1, 1, 1, hw)
    return serve


def check_family_artifact(family, tmp_path):
    """A ``--batch poly`` artifact of ``family`` on JAX-carried weights:
    loaded back, it is bit-equal to the live forward and within RTOL/ATOL
    of the JAX serving function at B = 1 and 2; only the PEMP graphs hold
    the mpm operators."""
    model, variables, port = carried(family)
    hw = hw_of(family)
    serve, inputs, dyn = X.build_serving_fn(family, port, "poly", 1, 1, hw,
                                            "cpu")
    loaded, exported, _ = roundtrip(serve, inputs, dyn, tmp_path, family)
    assert mpm_nodes(exported) == (sorted(MPM_OPS) if family in PEMP else [])
    jax_serve = jax_family_fn(model, variables, family)
    for b in (1, 2):
        arrays = episode(family, b, seed=b)
        got = run_port(loaded.module(), arrays)
        assert got.shape == (b, 1, hw, hw, 2)
        np.testing.assert_array_equal(got, run_port(serve, arrays))
        np.testing.assert_allclose(got, run_jax(jax_serve, arrays),
                                   rtol=RTOL, atol=ATOL)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with the artifacts the test wrote
    into it once the test ends (a full-width artifact is ~100 MB)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)
