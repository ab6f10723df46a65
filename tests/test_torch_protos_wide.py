"""p above 8 prototypes a class and ``dev.use_kernels`` (ROADMAP.md §3,
F9), on the CPU.

- ``dev.use_kernels`` parses as the JAX package's ``tpu.use_pallas`` on
  the same strings (and refuses what it refuses); a runtime's commands
  run inside the switch it sets, and the choice before comes back after;
  the kernels' remaining refusals name it.
- ``pad_protos`` / ``unpad_protos`` and ``padded_protos``: p = 9..16 run
  on the instances 12 and 16.
- PEMP stage 1 at ``net.protos=9`` (ResNet-50 cut to one block a stage,
  float64, 33x33, DropBlock off as tests/test_torch_train_parity.py has
  it: the two draw other masks) against the JAX package's
  (``use_pallas=False``, its jnp mpm) on the same numpy inputs: the
  forward's logits within 1e-6 of their largest magnitude, and one
  clipped SGD train step (cedt, train-mode BN, the trunk's BN frozen) per
  leaf within 1e-7 of the leaf's largest magnitude, as
  tests/test_torch_vgg_models.py holds them.

The padded plain stages of K4 are in tests/test_torch_mpm_backward_stages.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.config import Config as JaxConfig
from pemp_tpu.config.base import apply_overrides as jax_overrides
from pemp_tpu.core import losses as jax_losses
from pemp_tpu.models import common as jax_common
from pemp_tpu.models.pemp_stage1 import PEMPStage1 as JaxPEMPStage1
from pemp_tpu_torch import config as port_config
from pemp_tpu_torch.core import losses
from pemp_tpu_torch.core.experiment import EntryRuntime
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.ops import kernels
from pemp_tpu_torch.ops.kernels import mpm as K
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_parity_helpers import (  # noqa: F401  (fixture)
    assert_port_step_matches, draw_variables, episode, jax_sgd_step,
    one_torch_thread, tree64,
)

H = W = 33
P = 9
SMALL = (1, 1, 1)
SIGMA = 5.0
FWD_REL, REL = 1e-6, 1e-7
TR_CFG = SimpleNamespace(opt="sgd", lr=0.001, sgd_momentum=0.9,
                         sgd_nesterov=False, weight_decay=5e-4, grad_clip=1.1)


@pytest.mark.parametrize("text", ["off", "ON", "True", "false", "1", "0",
                                  "yes", "no"])
def test_use_kernels_parses_as_use_pallas(text):
    jax_cfg = jax_overrides(JaxConfig(), {"tpu.use_pallas": text})
    port = port_config.apply_overrides(port_config.Config(),
                                       {"dev.use_kernels": text})
    assert port.dev.use_kernels is jax_cfg.tpu.use_pallas
    assert port_config.Config().dev.use_kernels is JaxConfig().tpu.use_pallas


def test_use_kernels_refuses_what_use_pallas_refuses():
    with pytest.raises(ValueError):
        jax_overrides(JaxConfig(), {"tpu.use_pallas": "maybe"})
    with pytest.raises(ValueError):
        port_config.apply_overrides(port_config.Config(),
                                    {"dev.use_kernels": "maybe"})


def test_a_runtime_sets_the_kernel_switch():
    cfg = port_config.apply_overrides(port_config.Config(),
                                      {"dev.use_kernels": "off"})
    cuda = torch.device("cuda")
    off = EntryRuntime(cfg)
    assert kernels.kernels_on(cuda)        # building a runtime sets nothing
    with off.kernels():
        assert not kernels.kernels_on(cuda)
        with EntryRuntime(port_config.Config()).kernels():
            assert kernels.kernels_on(cuda)
        assert not kernels.kernels_on(cuda)
    assert kernels.kernels_on(cuda)        # the choice before comes back
    with pytest.raises(RuntimeError):
        with off.kernels():
            raise RuntimeError
    assert kernels.kernels_on(cuda)
    assert not kernels.kernels_on(torch.device("cpu"))


@pytest.mark.parametrize("p", [0, 17])
def test_the_kernels_refusal_names_use_kernels(p):
    with pytest.raises(ValueError, match="dev.use_kernels=False"):
        K.padded_protos(p)


@pytest.mark.parametrize("p,want", [(1, 1), (8, 8), (9, 12), (12, 12),
                                    (13, 16), (16, 16)])
def test_padded_instances_and_their_layout(p, want):
    assert K.padded_protos(p) == want
    x = torch.arange(2 * p * 3, dtype=torch.float32).reshape(3, 2 * p)
    padded = K.pad_protos(x, p, want, 1)
    assert padded.shape == (3, 2 * want)
    assert torch.equal(padded[:, :p], x[:, :p])
    assert torch.equal(padded[:, want:want + p], x[:, p:])
    assert not padded[:, p:want].any() and not padded[:, want + p:].any()
    assert torch.equal(K.unpad_protos(padded, p, want, 1), x)


@pytest.fixture(scope="module")
def carried():
    """JAX PEMPStage1 at protos=9 (jnp mpm), its ResNet-50 cut to one
    block a stage, float64; the port loaded with the same variables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_common.RESNET_LAYERS, "resnet50", SMALL)
        jax.config.update("jax_enable_x64", True)
        model = JaxPEMPStage1(backbone="resnet50", protos=P, drop_rate=0.0,
                              use_pallas=False, dtype=jnp.float64)
        zeros = (jnp.zeros((1, 1, H, W, 3)), jnp.zeros((1, 1, H, W, 2)),
                 jnp.zeros((1, 1, H, W, 3)))
        params, stats = draw_variables(model, zeros, 90)
        port = PEMPStage1(backbone="resnet50", protos=P, drop_rate=0.0,
                          layers=SMALL)
        port.load_state_dict(state_dict_from_jax(params, stats))
        yield model, tree64(params), tree64(stats), port.double()
        jax.config.update("jax_enable_x64", False)


def test_stage1_protos9_forward_matches_jax(carried):
    model, params, stats, port = carried
    sup, mask, qry = episode(91, 2, 1, 1, H, W)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, s, *a: model.apply(
            {"params": p, "batch_stats": s}, *a, out_hw=(H, W)))(
                params, stats, *map(jnp.asarray, (sup, mask, qry))))
    with torch.no_grad():
        got = port.eval()(*map(torch.from_numpy, (sup, mask, qry))).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FWD_REL * np.abs(want).max()


def test_stage1_protos9_train_step_matches_jax(carried):
    model, params, stats, port = carried
    b = 2
    sup, mask, qry = episode(92, b, 1, 1, H, W)
    labels = np.random.RandomState(93).randint(0, 2, (b, H, W))
    labels[:, :4, :6] = 255
    labels = labels.astype(np.int32)
    args = [jnp.asarray(a) for a in (sup, mask, qry)]

    def loss_fn(p):
        out, mutated = model.apply(
            {"params": p, "batch_stats": stats}, *args, out_hw=(H, W),
            train=True, mutable=["batch_stats"])
        return (jax_losses.cedt(out.reshape(b, H, W, 2), jnp.asarray(labels),
                                SIGMA, use_pallas=False),
                mutated["batch_stats"])

    want = jax_sgd_step(loss_fn, params, JaxPEMPStage1.FROZEN["resnet50"],
                        TR_CFG)
    port.train()
    out = port(*map(torch.from_numpy, (sup, mask, qry)))
    loss = losses.cedt(out.reshape(b, H, W, 2), torch.from_numpy(labels))
    assert_port_step_matches(port, loss, want, TR_CFG, REL)
