"""Baseline and PANet against the JAX package on the same numpy inputs at
float64, 33x33 (weights drawn from numpy at the init's scales, every BN's
affine and statistics randomised, carried across with
``state_dict_from_jax``):

- the Baseline forward with ``vgg16`` and with ``resnet50`` (the JAX
  Baseline builds the full ResNet-50, so the port does too) at 1 and 2
  shots, eval mode;
- the PANet forward and its alignment loss with ``vgg16`` and
  ``resnet50``;
- one train step each of Baseline and PANet with ``vgg16`` (the entries'
  default), ce loss (ignore 255), PANet's ``loss + loss_coef * align``,
  SGD without a clip as both entries train.

Tolerances: forward logits and the alignment loss rel 1e-6 of the largest
magnitude; the train steps per leaf within 1e-7 of the leaf's largest
magnitude, as tests/test_torch_train_parity.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.core import losses as jax_losses
from pemp_tpu.core import solver as jax_solver
from pemp_tpu.models.baseline import Baseline as JaxBaseline
from pemp_tpu.models.panet import PANet as JaxPANet
from pemp_tpu_torch.core import solver
from pemp_tpu_torch.core.experiment import EntryRuntime
from pemp_tpu_torch.entry import panet as panet_entry
from pemp_tpu_torch.models.baseline import Baseline
from pemp_tpu_torch.models.panet import PANet
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_parity_helpers import (
    assert_leaves_close, draw_variables, episode, sd64, tree64,
)

H = W = 33
FWD_REL, REL = 1e-6, 1e-7
LOSS_COEF = 0.7
TR_CFG = SimpleNamespace(opt="sgd", lr=0.001, sgd_momentum=0.9,
                         sgd_nesterov=False, weight_decay=5e-4, grad_clip=0.0)
FAMILIES = {"baseline": (JaxBaseline, Baseline), "panet": (JaxPANet, PANet)}


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _carried(name, backbone, seed, s=1):
    jax_cls, port_cls = FAMILIES[name]
    model = jax_cls(backbone=backbone, dtype=jnp.float64)
    zeros = (jnp.zeros((1, s, H, W, 3)), jnp.zeros((1, s, H, W, 2)),
             jnp.zeros((1, 1, H, W, 3)))
    params, stats = draw_variables(model, zeros, seed)
    port = port_cls(backbone=backbone)
    port.load_state_dict(state_dict_from_jax(params, stats))
    return model, {"params": tree64(params), "batch_stats": tree64(stats)}, \
        port.double()


def _close(got, want, rel=FWD_REL):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


@pytest.mark.parametrize("backbone,shot", [("vgg16", 1), ("vgg16", 2),
                                           ("resnet50", 1)])
def test_baseline_forward_matches_jax(x64, backbone, shot):
    model, variables, port = _carried("baseline", backbone, shot, s=shot)
    args = episode(shot + 3, 2, shot, 1, H, W)
    ref = jax.jit(lambda v, *a: model.apply(v, *a))(
        variables, *map(jnp.asarray, args))
    with torch.no_grad():
        ours = port.eval()(*map(torch.from_numpy, args))
    _close(ours.numpy(), ref)
    with torch.no_grad():
        feat = port(*map(torch.from_numpy, args), out_hw=None)
    assert feat.shape == (2, 1, 5, 5, 2)


@pytest.mark.parametrize("backbone", ["vgg16", "resnet50"])
def test_panet_forward_and_align_loss_match_jax(x64, backbone):
    model, variables, port = _carried("panet", backbone, 7)
    args = episode(8, 2, 1, 1, H, W)
    ref, ref_align = jax.jit(lambda v, *a: model.apply(v, *a))(
        variables, *map(jnp.asarray, args))
    with torch.no_grad():
        ours, align = port.eval()(*map(torch.from_numpy, args))
        logits_only = port(*map(torch.from_numpy, args), align=False)
    _close(ours.numpy(), ref)
    _close(align.numpy(), ref_align)
    assert torch.equal(logits_only, ours)
    assert 0.0 < float(align) < float("inf")


def _labels(seed, b):
    labels = np.random.RandomState(seed).randint(0, 2, (b, 1, H, W))
    labels[:, :, :5, :7] = 255
    return labels.astype(np.int32)


@pytest.mark.parametrize("name", ["baseline", "panet"])
def test_train_step_matches_jax(x64, name):
    b = 2
    model, variables, port = _carried(name, "vgg16", 20)
    args = episode(21, b, 1, 1, H, W)
    labels = _labels(22, b)
    jargs = [jnp.asarray(a) for a in args]
    params = variables["params"]

    def loss_fn(p):
        out = model.apply({"params": p}, *jargs, train=True)
        logits, aux = out if name == "panet" else (out, 0.0)
        base = jax_losses.cross_entropy(logits.reshape(b, H, W, 2),
                                        jnp.asarray(labels).reshape(b, H, W))
        return base + LOSS_COEF * aux

    with jax.default_matmul_precision("highest"):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        tx = jax_solver.make_optimizer(TR_CFG, jax_solver.trainable_mask(
            params, FAMILIES[name][0].FROZEN["vgg16"]))
        updates, _ = tx.update(grads, tx.init(params), params)
        new = jax_solver.apply_updates(params, updates, TR_CFG.lr)

    port.train()
    trained = port.freeze()
    assert len(trained) == len(list(port.parameters()))      # none frozen
    opt = solver.make_optimizer(TR_CFG, trained)
    opt.zero_grad(set_to_none=True)
    # the entries' hooks: PANet adds loss_coef * align to the base loss
    cfg = panet_entry.ex.assemble("train", {"split": "0", "loss": "ce",
                                            "loss_coef": str(LOSS_COEF)})
    runtime = (panet_entry.PANetRuntime(cfg) if name == "panet"
               else EntryRuntime(cfg))
    batch = dict(zip(("sup_rgb", "sup_mask", "qry_rgb"),
                     map(torch.from_numpy, args)),
                 qry_msk=torch.from_numpy(labels))
    logits, aux = runtime.apply_train(port, batch)
    loss_t = runtime.compute_loss(logits, batch, aux)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss), rtol=REL)
    got = {k: p.grad for k, p in port.named_parameters()}
    want = sd64(grads, {})
    assert set(got) == set(want)
    assert_leaves_close(got, want, REL, "grad")
    solver.clip_gradients(trained, TR_CFG.grad_clip)
    opt.step()
    assert_leaves_close({k: p.detach() for k, p in port.named_parameters()},
                        sd64(new, {}), REL, "sgd step")
