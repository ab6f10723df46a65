"""PEMP stage 1 and stage 2 with ``vgg16`` against the JAX package, at
float64 on the same numpy inputs (weights drawn from numpy at the init's
scales and carried across with ``state_dict_from_jax``), 33x33:

- the forward of ``PEMPStage1`` (VGG16, no purifier) and of
  ``PEMPStage2`` (VGG16CM, no purifier) at 1 and 5 shots: logits and
  response maps;
- one train step of PEMP-VGG16 stage 1 (cedt, clipped SGD: clip 1.1 as
  the stage-1 entry sets it; nothing frozen, VGG16 has no BatchNorm);
- one train step of the VGG16CM cascade: stage 1 (VGG16, train mode, no
  gradient) gives the query prior, stage 2 (VGG16CM) trains with cedt
  and clip 1.1, as the stage-2 entry sets it for ``vgg16``; stage 1
  bit-equal afterwards. The JAX gradient is taken jitted and checked
  against its eager one (F2 found them apart for ``ResNetCM``; for
  ``VGG16CM`` they agree).

Tolerances: forward logits rel 1e-6 of the largest magnitude, response
maps equal; the train steps per leaf within 1e-7 of the leaf's largest
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
from pemp_tpu.models.pemp_stage1 import PEMPStage1 as JaxPEMPStage1
from pemp_tpu.models.pemp_stage2 import PEMPStage2 as JaxPEMPStage2
from pemp_tpu_torch.core import losses, solver
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.models.pemp_stage2 import PEMPCascade, PEMPStage2
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_parity_helpers import (  # noqa: F401  (fixture)
    assert_leaves_close, draw_variables, episode, one_torch_thread, sd64,
    tree64,
)

H = W = 33
SIGMA = 5.0
FWD_REL, REL = 1e-6, 1e-7
TR_CFG = SimpleNamespace(opt="sgd", lr=0.001, sgd_momentum=0.9,
                         sgd_nesterov=False, weight_decay=5e-4, grad_clip=1.1)


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _zeros(s, q):
    return (jnp.zeros((1, s, H, W, 3)), jnp.zeros((1, s, H, W, 2)),
            jnp.zeros((1, q, H, W, 3)))


def _stage1(seed, s=1, q=1):
    model = JaxPEMPStage1(backbone="vgg16", protos=3, dtype=jnp.float64)
    params, _ = draw_variables(model, _zeros(s, q), seed)
    port = PEMPStage1(backbone="vgg16", protos=3)
    port.load_state_dict(state_dict_from_jax(params, {}))
    return model, tree64(params), port.double()


def _stage2(seed, s=1, q=1):
    model = JaxPEMPStage2(backbone="vgg16", protos=3, spq=s + q,
                          dtype=jnp.float64)
    params, _ = draw_variables(
        model, (*_zeros(s, q), jnp.zeros((1, q, H, W))), seed)
    port = PEMPStage2(backbone="vgg16", protos=3)
    port.load_state_dict(state_dict_from_jax(params, {}))
    return model, tree64(params), port.double()


def _close(got, want, rel):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


@pytest.mark.parametrize("shot", [1, 5])
def test_pemp_stage1_vgg16_forward_matches_jax(x64, shot):
    model, params, port = _stage1(shot, s=shot)
    sup, mask, qry = episode(shot, 1 if shot == 5 else 2, shot, 1, H, W)
    ref, ref_resp = jax.jit(lambda p, *a: model.apply(
        {"params": p}, *a, ret_ind=True))(params, *map(jnp.asarray,
                                                       (sup, mask, qry)))
    with torch.no_grad():
        ours, resp = port.eval()(*map(torch.from_numpy, (sup, mask, qry)),
                                 ret_ind=True)
    _close(ours.numpy(), ref, FWD_REL)
    np.testing.assert_array_equal(resp.numpy(), np.asarray(ref_resp))


@pytest.mark.parametrize("shot", [1, 5])
def test_pemp_stage2_vgg16_forward_matches_jax(x64, shot):
    model, params, port = _stage2(shot + 10, s=shot)
    b = 1 if shot == 5 else 2
    sup, mask, qry = episode(shot + 10, b, shot, 1, H, W)
    prior = (np.random.RandomState(shot).rand(b, 1, H, W) > 0.5).astype(
        np.float64)
    args = (sup, mask, qry, prior)
    ref, ref_resp = jax.jit(lambda p, *a: model.apply(
        {"params": p}, *a, ret_ind=True))(params, *map(jnp.asarray, args))
    with torch.no_grad():
        ours, resp = port.eval()(*map(torch.from_numpy, args), ret_ind=True)
    _close(ours.numpy(), ref, FWD_REL)
    np.testing.assert_array_equal(resp.numpy(), np.asarray(ref_resp))


def _labels(rng, b):
    labels = rng.randint(0, 2, (b, H, W)).astype(np.int32)
    labels[:, :5, :7] = 255
    return labels


def _jax_step(loss_fn, params):
    """(loss, grads, params after the clipped SGD step), nothing frozen."""
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = jax_solver.make_optimizer(
        TR_CFG, jax_solver.trainable_mask(params, []))
    updates, _ = tx.update(grads, tx.init(params), params)
    return loss, grads, jax_solver.apply_updates(params, updates,
                                                 TR_CFG.lr)


def _port_step(trained, forward, labels, want):
    params = trained.freeze()
    assert len(params) == len(list(trained.parameters()))   # none frozen
    opt = solver.make_optimizer(TR_CFG, params)
    opt.zero_grad(set_to_none=True)
    logits = forward()
    loss = losses.cedt(logits.reshape(-1, H, W, 2), labels, SIGMA)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want["loss"], rtol=REL)
    grads = {k: p.grad for k, p in trained.named_parameters()}
    assert set(grads) == set(want["grads"])
    assert_leaves_close(grads, want["grads"], REL, "grad")
    solver.clip_gradients(params, TR_CFG.grad_clip)
    opt.step()
    assert_leaves_close({k: p.detach() for k, p in trained.named_parameters()},
                        want["params"], REL, "sgd step")


def test_pemp_stage1_vgg16_train_step_matches_jax(x64):
    b = 2
    model, params, port = _stage1(30)
    sup, mask, qry = episode(30, b, 1, 1, H, W)
    labels = _labels(np.random.RandomState(31), b)
    args = [jnp.asarray(a) for a in (sup, mask, qry)]

    def loss_fn(p):
        out = model.apply({"params": p}, *args, out_hw=(H, W), train=True)
        return jax_losses.cedt(out.reshape(b, H, W, 2), jnp.asarray(labels),
                               SIGMA, use_pallas=False)

    with jax.default_matmul_precision("highest"):
        loss, grads, new = _jax_step(loss_fn, params)
    port.train()
    _port_step(port, lambda: port(*map(torch.from_numpy,
                                              (sup, mask, qry))),
               torch.from_numpy(labels),
               {"loss": float(loss), "grads": sd64(grads, {}),
                "params": sd64(new, {})})


def test_vgg16cm_cascade_train_step_matches_jax(x64):
    b = 2
    jax1, p1, stage1 = _stage1(40)
    jax2, p2, stage2 = _stage2(41)
    sup, mask, qry = episode(42, b, 1, 1, H, W)
    labels = _labels(np.random.RandomState(43), b)
    args = [jnp.asarray(a) for a in (sup, mask, qry)]
    prior = jnp.argmax(jax.jit(lambda p: jax1.apply(
        {"params": p}, *args, out_hw=(H, W), train=True))(p1),
        -1).astype(jnp.float64)

    def loss_fn(p):
        out = jax2.apply({"params": p}, *args, prior, out_hw=(H, W),
                         train=True)
        return jax_losses.cedt(out.reshape(b, H, W, 2), jnp.asarray(labels),
                               SIGMA, use_pallas=False)

    with jax.default_matmul_precision("highest"):
        loss, grads, new = _jax_step(loss_fn, p2)
        with jax.disable_jit():
            eager = jax.grad(loss_fn)(p2)
    # the jitted JAX gradient agrees with its eager one here
    assert_leaves_close(sd64(grads, {}), sd64(eager, {}), REL,
                        "JAX jitted vs eager grad")
    cascade = PEMPCascade(stage1, stage2).train()
    before = {k: v.clone() for k, v in cascade.stage1.state_dict().items()}
    inputs = [torch.from_numpy(a) for a in (sup, mask, qry)]
    np.testing.assert_array_equal(cascade.prior(*inputs).numpy(),
                                  np.asarray(prior))
    _port_step(cascade.stage2, lambda: cascade(*inputs),
               torch.from_numpy(labels),
               {"loss": float(loss), "grads": sd64(grads, {}),
                "params": sd64(new, {})})
    assert all(p.grad is None for p in cascade.stage1.parameters())
    after = cascade.stage1.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
