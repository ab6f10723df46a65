"""One train step of the stage-2 cascade in float64: the port
(``PEMPCascade`` in train mode, ``.double()``, the ``MPMChainPacked``
backward, the min-plus EDT of the cedt loss, ``core/solver.py``) against
the JAX package (x64, ``use_pallas=False``, ``jax.value_and_grad``,
optax), as ``entry/pemp_stage2.py`` runs the cascade in training:

- stage 1 in train mode (batch-statistics BN, DropBlock rate 0) under no
  gradient, its BN running-stat updates discarded, its argmax the query
  prior;
- stage 2 (ResNetCM + PurifierV1, Dropout2d rate 0), cedt (sigma 5), SGD
  (momentum 0.9, wd 5e-4) without a gradient clip, its backbone BNs
  frozen.

ResNet-50 on both stages at 33x33, B=2, 1-shot; the JAX weights (drawn
from numpy) are carried across with ``state_dict_from_jax``. Checked: the
prior, the loss, the gradient of every stage-2 leaf, stage 2's BN
running-stat update, the parameters after the step, and stage 1's
``state_dict`` bit-equal afterwards. The JAX gradient is taken eagerly
(``jax.disable_jit``): jitted on XLA:CPU it disagrees with its own eager
gradient and with central differences (ROADMAP.md section 4).

Tolerance: per leaf, max abs error <= 1e-7 of the leaf's largest
magnitude, as tests/test_torch_train_parity.py; the CM linears' biases,
whose gradient is zero in exact arithmetic, within 1e-7 of their weight's
largest gradient of zero on both sides.
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
from tests.test_torch_parity_helpers import (
    assert_leaves_close, draw_variables, sd64, tree64,
)

H = W = 33
B, S, Q = 2, 1, 1
SIGMA = 5.0
LR = 0.0035
REL = 1e-7
TR_CFG = SimpleNamespace(opt="sgd", lr=LR, sgd_momentum=0.9,
                         sgd_nesterov=False, weight_decay=5e-4, grad_clip=0.0)


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def step(x64):
    """The JAX side of one cascade train step, and the port's cascade
    loaded with the same float64 weights."""
    rng = np.random.RandomState(20)
    sup = rng.randn(B, S, H, W, 3)
    fg = (rng.rand(B, S, H, W, 1) > 0.5).astype(np.float64)
    mask = np.concatenate([fg, 1 - fg], -1)
    qry = rng.randn(B, Q, H, W, 3)
    labels = rng.randint(0, 2, (B * Q, H, W)).astype(np.int32)
    labels[:, :5, :7] = 255

    x = jnp.zeros((1, S, H, W, 3))
    m = jnp.zeros((1, S, H, W, 2))
    jax1 = JaxPEMPStage1(backbone="resnet50", protos=3, drop_rate=0.0,
                         dtype=jnp.float64)
    jax2 = JaxPEMPStage2(backbone="resnet50", protos=3, drop_rate=0.0,
                         spq=S + Q, dtype=jnp.float64)
    p1, s1 = draw_variables(jax1, (x, m, x), 0)
    p2, s2 = draw_variables(jax2, (x, m, x, jnp.zeros((1, Q, H, W))), 1)
    stage1 = PEMPStage1(backbone="resnet50", protos=3, drop_rate=0.0)
    stage1.load_state_dict(state_dict_from_jax(p1, s1))
    stage2 = PEMPStage2(backbone="resnet50", protos=3, drop_rate=0.0)
    stage2.load_state_dict(state_dict_from_jax(p2, s2))
    v1 = {"params": tree64(p1), "batch_stats": tree64(s1)}
    p2, s2 = tree64(p2), tree64(s2)
    args = [jnp.asarray(a) for a in (sup, mask, qry)]

    def prior_fn(v):
        # train mode, the BN updates dropped (entry/pemp_stage2.py:78-84)
        logits, _ = jax1.apply(v, *args, out_hw=(H, W), train=True,
                               mutable=["batch_stats"])
        return jnp.argmax(logits, -1).astype(jnp.float64)

    def loss_fn(p, prior):
        out, mutated = jax2.apply(
            {"params": p, "batch_stats": s2}, *args, prior, out_hw=(H, W),
            train=True, mutable=["batch_stats"])
        lg = out.reshape(B * Q, H, W, 2)
        return (jax_losses.cedt(lg, jnp.asarray(labels), SIGMA,
                                use_pallas=False), mutated["batch_stats"])

    with jax.default_matmul_precision("highest"):
        prior = jax.jit(prior_fn)(v1)
        # eager: the jitted gradient of the JAX ResNetCM in train mode is
        # wrong on XLA:CPU (ROADMAP.md section 4); the eager one agrees
        # with central differences of the same forward
        with jax.disable_jit():
            (loss, new_stats), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(p2, prior)
        tx = jax_solver.make_optimizer(TR_CFG, jax_solver.trainable_mask(
            p2, JaxPEMPStage2.FROZEN["resnet50"]))
        updates, _ = tx.update(grads, tx.init(p2), p2)
        new_params = jax_solver.apply_updates(p2, updates, LR)
    cascade = PEMPCascade(stage1, stage2).double().train()
    return {"cascade": cascade, "prior": np.asarray(prior),
            "inputs": [torch.from_numpy(a) for a in (sup, mask, qry)],
            "labels": torch.from_numpy(labels), "loss": float(loss),
            "grads": sd64(grads, {}), "stats": sd64({}, new_stats),
            "params": sd64(new_params, {}),
            "stage1": {k: v.clone() for k, v in
                       cascade.stage1.state_dict().items()}}


def test_cascade_train_step_matches_jax(step):
    cascade = step["cascade"]
    params = cascade.freeze()
    opt = solver.make_optimizer(TR_CFG, params)
    opt.zero_grad(set_to_none=True)
    np.testing.assert_array_equal(
        cascade.prior(*step["inputs"]).numpy(), step["prior"])
    logits = cascade(*step["inputs"])
    loss = losses.cedt(logits.reshape(B * Q, H, W, 2), step["labels"], SIGMA)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), step["loss"], rtol=REL)
    stage2 = cascade.stage2
    grads = {k: p.grad for k, p in stage2.named_parameters()
             if p.requires_grad}
    frozen = {k for k, p in stage2.named_parameters() if not p.requires_grad}
    assert "encoder.backbone.layer2.0.downsample.1.weight" in frozen
    assert "encoder.backbone.linear2.weight" in grads
    assert set(grads) | frozen == set(step["grads"])
    # the CM linears' biases add a constant over the whole batch ahead of
    # 1x1 convolutions and train-mode BNs, which remove it: their gradient
    # is zero in exact arithmetic, rounding on either side, so each is held
    # to zero against its weight's gradient instead of to the other side
    for i in (1, 2, 3):
        key = f"encoder.backbone.linear{i}"
        scale = REL * step["grads"][f"{key}.weight"].abs().max()
        assert grads[f"{key}.bias"].abs().max() <= scale
        assert step["grads"][f"{key}.bias"].abs().max() <= scale
    assert_leaves_close(grads, {k: step["grads"][k] for k in grads
                                if not k.startswith("encoder.backbone.linear")
                                or k.endswith(".weight")}, REL, "grad")
    solver.clip_gradients(params, TR_CFG.grad_clip)
    opt.step()
    state = stage2.state_dict()
    assert_leaves_close({k: state[k] for k in step["stats"]}, step["stats"],
                        REL, "stage-2 running stats")
    assert_leaves_close({k: p.detach() for k, p in stage2.named_parameters()},
                        step["params"], REL, "sgd step")
    # stage 1: no gradient, and its weights and BN buffers bit-equal
    assert all(p.grad is None for p in cascade.stage1.parameters())
    after = cascade.stage1.state_dict()
    assert set(after) == set(step["stage1"])
    assert all(torch.equal(after[k], v) for k, v in step["stage1"].items())


EPOCHS, STEPS = 4, 5
TRAJ_REL = 1e-6     # tests/test_train_parity.py's trajectory tolerance
LAYERS = (1, 1, 1)


@pytest.mark.slow
def test_pemp_stage2_20step_trajectory_matches_jax(x64, monkeypatch):
    """4 epochs of 5 train steps of the cascade through the port's
    ``Trainer.train_step`` (cedt, SGD momentum 0.9, wd 5e-4, no clip, the
    per-epoch ``period_step`` LR: 0.1x every 2 epochs) against the JAX
    package's optimizer and ``LRPolicy`` from the same float64 weights, a
    fresh episode batch a step, as tests/test_train_parity.py:1076-1077
    holds the JAX package to torch: every step's loss, and after the last
    step stage 2's parameters and BN running statistics, each leaf within
    1e-6 of its largest magnitude. One bottleneck a ResNet stage on both
    sides, so that the JAX gradient, taken eagerly (ROADMAP.md section 3,
    F2), stays cheap."""
    from pemp_tpu.models import common as jax_common
    from pemp_tpu_torch.config import Run
    from pemp_tpu_torch.core.trainer import Trainer
    from pemp_tpu_torch.entry import pemp_stage2 as entry
    from tests.test_torch_parity_helpers import episode

    monkeypatch.setitem(jax_common.RESNET_LAYERS, "resnet50", LAYERS)
    x, m = jnp.zeros((1, S, H, W, 3)), jnp.zeros((1, S, H, W, 2))
    jax1 = JaxPEMPStage1(backbone="resnet50", protos=3, drop_rate=0.0,
                         dtype=jnp.float64)
    jax2 = JaxPEMPStage2(backbone="resnet50", protos=3, drop_rate=0.0,
                         spq=S + Q, dtype=jnp.float64)
    p1, s1 = draw_variables(jax1, (x, m, x), 2)
    p2, s2 = draw_variables(jax2, (x, m, x, jnp.zeros((1, Q, H, W))), 3)
    stage1 = PEMPStage1(backbone="resnet50", protos=3, drop_rate=0.0,
                        layers=LAYERS)
    stage1.load_state_dict(state_dict_from_jax(p1, s1))
    stage2 = PEMPStage2(backbone="resnet50", protos=3, drop_rate=0.0,
                        layers=LAYERS)
    stage2.load_state_dict(state_dict_from_jax(p2, s2))
    cascade = PEMPCascade(stage1, stage2).double().train()
    v1 = {"params": tree64(p1), "batch_stats": tree64(s1)}
    params, stats = tree64(p2), tree64(s2)

    cfg = entry.ex.assemble("train", {
        "split": "0", "loss": "cedt", "sigma": str(SIGMA), "tr.lr": str(LR),
        "tr.lrp": "period_step", "tr.lr_step": "2", "tr.lr_rate": "0.1",
        "dev.device": "cpu", "dev.compact_wire": "False"})
    runtime = entry.Stage2Runtime(cfg)
    assert cfg.tr.grad_clip == 0.0
    trained = cascade.freeze()
    opt = solver.make_optimizer(cfg.tr, trained)
    lr_policy = solver.LRPolicy(cfg.tr, EPOCHS * STEPS)
    trainer = Trainer(cfg, Run(None, None), cascade, opt, trained, runtime,
                      lr_policy, torch.device("cpu"), weights=stage2)

    tx, opt_state, jax_lr, _ = jax_solver.get(
        cfg.tr, params, JaxPEMPStage2.FROZEN["resnet50"], EPOCHS * STEPS)
    def loss_fn(p, st, args, prior, labels):
        out, mutated = jax2.apply(
            {"params": p, "batch_stats": st}, *args, prior, out_hw=(H, W),
            train=True, mutable=["batch_stats"])
        return (jax_losses.cedt(out.reshape(B * Q, H, W, 2), labels, SIGMA,
                                use_pallas=False), mutated["batch_stats"])

    # stage 1 is frozen and its BN updates dropped (entry/pemp_stage2.py)
    prior_fn = jax.jit(lambda v, args: jnp.argmax(jax1.apply(
        v, *args, out_hw=(H, W), train=True, mutable=["batch_stats"])[0],
        -1).astype(jnp.float64))
    data_rng = np.random.RandomState(78)
    with jax.default_matmul_precision("highest"):
        for epoch in range(EPOCHS):
            for j in range(STEPS):
                sup, mask, qry = episode(data_rng.randint(2 ** 31), B, S, Q,
                                         H, W)
                labels = data_rng.randint(0, 2, (B * Q, H, W))
                labels[:, :5, :7] = 255
                args = [jnp.asarray(a) for a in (sup, mask, qry)]
                assert lr_policy.lr == pytest.approx(jax_lr.lr, rel=1e-15)
                with jax.disable_jit():
                    (loss, stats), grads = jax.value_and_grad(
                        loss_fn, has_aux=True)(params, stats, args,
                                               prior_fn(v1, args),
                                               jnp.asarray(labels))
                updates, opt_state = tx.update(grads, opt_state, params)
                params = jax_solver.apply_updates(params, updates, jax_lr.lr)
                ours = float(trainer.train_step({
                    "sup_rgb": sup, "sup_mask": mask, "qry_rgb": qry,
                    "qry_msk": labels.reshape(B, Q, H, W).astype(np.int32)}))
                np.testing.assert_allclose(
                    ours, float(loss), rtol=TRAJ_REL,
                    err_msg=f"epoch {epoch} step {j} loss")
            jax_lr.step_epoch()
            lr_policy.step_epoch()
    assert lr_policy.lr == pytest.approx(LR * 0.01)
    state = stage2.state_dict()
    want_stats = sd64({}, stats)
    assert_leaves_close({k: state[k] for k in want_stats}, want_stats,
                        TRAJ_REL, "stage-2 running stats after 20 steps")
    want = sd64(params, {})
    # the CM linears' biases: zero gradient in exact arithmetic (see the
    # one-step test), so only weight decay and momentum move them
    assert_leaves_close({k: p.detach() for k, p in stage2.named_parameters()},
                        want, TRAJ_REL, "stage-2 params after 20 steps")
