"""One train step of the whole PEMP stage-1 model in float64: the port
(``torch .double()``, train mode, the ``MPMChainPacked`` backward, the
min-plus EDT of the cedt loss, ``core/solver.py``) against the JAX
package (x64, ``use_pallas=False``, ``jax.value_and_grad``, optax), as
tests/test_train_parity.py holds the JAX package against torch mirrors.

ResNet-50 at 33x33, B=2, 1-shot, DropBlock rate 0, cedt (sigma 5); the
JAX weights (BN statistics and affine randomised from numpy) are carried
across with ``state_dict_from_jax``. Checked: the loss, the gradient of
every leaf, the BN running-stat update and the parameters after one
clipped SGD step (momentum 0.9, wd 5e-4, clip 1.1) with the backbone BNs
frozen. Everything is compared through ``state_dict_from_jax``, which
stores float32: each float64 tree goes across as a float32 high part plus
a float32 low part.

Tolerance: per leaf, max abs error <= 1e-7 of the leaf's largest
magnitude (at float64 the floor is ~1e-10; at float32 chaotic
cancellation alone moves gradients by ~1e-2).

``test_pemp_stage1_20step_trajectory_matches_jax`` (``slow``) runs 20
steps of the port's trainer against the JAX package's, at 1e-6; run as a
script, this file prints how far the JAX package drifts from itself over
those steps:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_parity.py
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from pemp_tpu.core import losses as jax_losses
from pemp_tpu.core import solver as jax_solver
from pemp_tpu.models.pemp_stage1 import PEMPStage1 as JaxPEMPStage1
from pemp_tpu_torch.core import losses, solver
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_parity_helpers import assert_leaves_close, sd64, tree64

H = W = 33
B, S, Q = 2, 1, 1
SIGMA = 5.0
LR = 0.025
REL = 1e-7
TR_CFG = SimpleNamespace(opt="sgd", lr=LR, sgd_momentum=0.9,
                         sgd_nesterov=False, weight_decay=5e-4, grad_clip=1.1)


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def jax_init(x64):
    return _jax_init()


def _jax_init():
    """The JAX model at float64 and its init (float32 values), every BN's
    affine and running statistics randomised from numpy."""
    model = JaxPEMPStage1(backbone="resnet50", protos=3, drop_rate=0.0,
                          dtype=jnp.float64)
    variables = jax.jit(lambda k: model.init(
        {"params": k}, jnp.zeros((1, S, H, W, 3)), jnp.zeros((1, S, H, W, 2)),
        jnp.zeros((1, Q, H, W, 3))))(jax.random.PRNGKey(0))
    # float32 values on both sides (x64 draws some initialisers in f64)
    params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                    variables["params"])
    stats = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                   variables["batch_stats"])
    bn_rng = np.random.RandomState(11)
    for path, leaf in traverse_util.flatten_dict(params).items():
        if path[-2:-1] == ("BatchNorm_0",):
            draw = (bn_rng.uniform(0.5, 1.5, leaf.shape) if path[-1] == "scale"
                    else 0.1 * bn_rng.randn(*leaf.shape))
            leaf[...] = draw.astype(np.float32)
    for path, leaf in traverse_util.flatten_dict(stats).items():
        draw = (0.1 * bn_rng.randn(*leaf.shape) if path[-1] == "mean"
                else bn_rng.uniform(0.5, 1.5, leaf.shape))
        leaf[...] = draw.astype(np.float32)
    return model, params, stats


def _episode(rng):
    """Support and query images, [fg, bg] masks, labels with an ignored
    corner (255), float64."""
    sup = rng.randn(B, S, H, W, 3)
    fg = (rng.rand(B, S, H, W, 1) > 0.5).astype(np.float64)
    mask = np.concatenate([fg, 1 - fg], -1)
    qry = rng.randn(B, Q, H, W, 3)
    labels = rng.randint(0, 2, (B * Q, H, W)).astype(np.int32)
    labels[:, :5, :7] = 255
    return sup, mask, qry, labels


@pytest.fixture(scope="module")
def step(jax_init):
    """The JAX side of one train step, and the port loaded with the same
    float64 weights."""
    sup, mask, qry, labels = _episode(np.random.RandomState(10))
    model, params, stats = jax_init
    params = jax.tree_util.tree_map(np.copy, params)
    stats = jax.tree_util.tree_map(np.copy, stats)
    port = PEMPStage1(backbone="resnet50", protos=3, drop_rate=0.0)
    port.load_state_dict(state_dict_from_jax(params, stats))
    params, stats = tree64(params), tree64(stats)

    def loss_fn(p):
        out, mutated = model.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(sup),
            jnp.asarray(mask), jnp.asarray(qry), out_hw=(H, W), train=True,
            mutable=["batch_stats"])
        lg = out.reshape(B * Q, H, W, 2)
        return (jax_losses.cedt(lg, jnp.asarray(labels), SIGMA,
                                use_pallas=False), mutated["batch_stats"])

    with jax.default_matmul_precision("highest"):
        (loss, new_stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        frozen = JaxPEMPStage1.FROZEN["resnet50"]
        tx = jax_solver.make_optimizer(
            TR_CFG, jax_solver.trainable_mask(params, frozen))
        updates, _ = tx.update(grads, tx.init(params), params)
        new_params = jax_solver.apply_updates(params, updates, LR)
    inputs = [torch.from_numpy(a) for a in (sup, mask, qry)]
    return {"port": port.double().train(), "inputs": inputs,
            "labels": torch.from_numpy(labels), "loss": float(loss),
            "grads": sd64(grads, {}), "stats": sd64({}, new_stats),
            "params": sd64(new_params, {}),
            "before": {k: v.clone() for k, v in port.state_dict().items()}}


def _forward_loss(port, step):
    logits = port(*step["inputs"])
    return losses.cedt(logits.reshape(B * Q, H, W, 2), step["labels"], SIGMA)


def test_loss_grads_and_bn_stats_match_jax(step):
    port = step["port"]
    port.load_state_dict(step["before"])
    port.zero_grad(set_to_none=True)
    loss = _forward_loss(port, step)
    stats = {k: v for k, v in port.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), step["loss"], rtol=REL)
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert set(grads) == set(step["grads"])
    assert_leaves_close(grads, step["grads"], REL, "grad")
    assert set(stats) == set(step["stats"])
    assert_leaves_close(stats, step["stats"], REL, "running stats")


def test_clipped_sgd_step_with_frozen_bn_matches_jax(step):
    port = step["port"]
    port.load_state_dict(step["before"])
    params = port.freeze()
    frozen = {k for k, p in port.named_parameters() if not p.requires_grad}
    assert frozen and all(re.search(r"^encoder\.backbone\..*\.(weight|bias)$",
                                    k) for k in frozen)
    # the downsample BNs (layerK.0.downsample.1) are frozen like the rest
    assert "encoder.backbone.layer1.0.downsample.1.weight" in frozen
    assert "encoder.backbone.layer1.0.downsample.0.weight" not in frozen
    opt = solver.make_optimizer(TR_CFG, params)
    opt.zero_grad(set_to_none=True)
    _forward_loss(port, step).backward()
    solver.clip_gradients(params, TR_CFG.grad_clip)
    opt.step()
    after = dict(port.named_parameters())
    assert_leaves_close({k: p.detach() for k, p in after.items()},
                        step["params"], REL, "sgd step")
    for k in frozen:
        assert torch.equal(after[k].detach(), step["before"][k])
    for p in port.parameters():
        p.requires_grad_(True)


N_STEPS = 20
TRAJ_REL = 1e-6     # tests/test_train_parity.py's trajectory tolerance


@pytest.mark.slow
def test_pemp_stage1_20step_trajectory_matches_jax(jax_init):
    """20 consecutive train steps of the port's ``Trainer.train_step``
    (cedt, clip 1.1, SGD momentum 0.9, wd 5e-4, the per-step poly LR of
    ``solver.LRPolicy``) against the JAX package's optimizer and
    ``LRPolicy`` from the same float64 weights, a fresh episode batch a
    step (as ``_run_trajectory`` in tests/test_train_parity.py:832 feeds
    its 20-step test, :935-936): every step's loss, and after the last the
    parameters and the BN running statistics, each leaf within 1e-6 of
    its largest magnitude.

    Fresh batches, as there: with one noise batch repeated, the JAX
    package drifts from itself (its weights moved by 1e-15 relative) past
    1e-6 within 20 steps, so no port could match it; with fresh batches
    that drift stays far below (``python tests/test_torch_train_parity.py``
    prints both, step by step)."""
    from pemp_tpu_torch.config import Run
    from pemp_tpu_torch.core.trainer import Trainer
    from pemp_tpu_torch.entry import pemp_stage1 as entry

    model, params, stats = jax_init
    port = PEMPStage1(backbone="resnet50", protos=3, drop_rate=0.0)
    port.load_state_dict(state_dict_from_jax(params, stats))
    port = port.double().train()
    params, stats = tree64(params), tree64(stats)

    cfg = entry.ex.assemble("train", {
        "split": "0", "loss": "cedt", "sigma": str(SIGMA), "tr.lr": str(LR),
        "tr.lrp": "poly", "tr.power": "0.9", "dev.device": "cpu",
        "dev.compact_wire": "False"})
    trained = port.freeze()
    opt = solver.make_optimizer(cfg.tr, trained)
    lr_policy = solver.LRPolicy(cfg.tr, N_STEPS)
    trainer = Trainer(cfg, Run(None, None), port, opt, trained,
                      entry.Stage1Runtime(cfg), lr_policy,
                      torch.device("cpu"))
    tx, opt_state, jax_lr, _ = jax_solver.get(
        cfg.tr, params, JaxPEMPStage1.FROZEN["resnet50"], N_STEPS)

    def loss_fn(p, st, sup, mask, qry, labels):
        out, mutated = model.apply(
            {"params": p, "batch_stats": st}, sup, mask, qry, out_hw=(H, W),
            train=True, mutable=["batch_stats"])
        return (jax_losses.cedt(out.reshape(B * Q, H, W, 2), labels, SIGMA,
                                use_pallas=False), mutated["batch_stats"])

    data_rng = np.random.RandomState(77)
    with jax.default_matmul_precision("highest"):
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        for j in range(N_STEPS):
            sup, mask, qry, labels = _episode(data_rng)
            assert lr_policy.lr == pytest.approx(jax_lr.lr, rel=1e-15)
            (loss, stats), grads = grad_fn(params, stats, *map(
                jnp.asarray, (sup, mask, qry, labels)))
            updates, opt_state = tx.update(grads, opt_state, params)
            params = jax_solver.apply_updates(params, updates, jax_lr.lr)
            jax_lr.step_step()
            ours = float(trainer.train_step({
                "sup_rgb": sup, "sup_mask": mask, "qry_rgb": qry,
                "qry_msk": labels.reshape(B, Q, H, W)}))
            lr_policy.step_step()
            np.testing.assert_allclose(ours, float(loss), rtol=TRAJ_REL,
                                       err_msg=f"step {j} loss")
    state = port.state_dict()
    want_stats = sd64({}, stats)
    assert_leaves_close({k: state[k] for k in want_stats}, want_stats,
                        TRAJ_REL, "running stats after 20 steps")
    assert_leaves_close({k: p.detach() for k, p in port.named_parameters()},
                        sd64(params, {}), TRAJ_REL, "params after 20 steps")


def _jax_drift(fresh: bool):
    """Per step, the relative difference of the JAX package's loss from
    its own with every weight moved by 1e-15 relative, over the 20 steps
    of the trajectory test: a fresh batch a step, or its first batch
    repeated."""
    model, params, stats = _jax_init()
    tr = SimpleNamespace(**vars(TR_CFG), lrp="poly", power=0.9, lr_end=0.0)
    frozen = JaxPEMPStage1.FROZEN["resnet50"]

    def loss_fn(p, st, sup, mask, qry, labels):
        out, mutated = model.apply(
            {"params": p, "batch_stats": st}, sup, mask, qry, out_hw=(H, W),
            train=True, mutable=["batch_stats"])
        return (jax_losses.cedt(out.reshape(B * Q, H, W, 2), labels, SIGMA,
                                use_pallas=False), mutated["batch_stats"])

    runs = []
    for scale in (1.0, 1.0 + 1e-15):
        p = jax.tree_util.tree_map(lambda x: np.float64(x) * scale,
                                   tree64(params))
        st = tree64(stats)
        tx, opt_state, lr, _ = jax_solver.get(tr, p, frozen, N_STEPS)
        data_rng, losses = np.random.RandomState(77), []
        with jax.default_matmul_precision("highest"):
            grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
            batch = _episode(data_rng)
            for _ in range(N_STEPS):
                (loss, st), grads = grad_fn(p, st, *map(jnp.asarray, batch))
                updates, opt_state = tx.update(grads, opt_state, p)
                p = jax_solver.apply_updates(p, updates, lr.lr)
                lr.step_step()
                losses.append(float(loss))
                if fresh:
                    batch = _episode(data_rng)
        runs.append(np.array(losses))
    return np.abs(runs[1] - runs[0]) / np.abs(runs[0])


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_parity.py
    jax.config.update("jax_enable_x64", True)
    for fresh in (False, True):
        print("fresh batches" if fresh else "one batch repeated",
              " ".join(f"{d:.3g}" for d in _jax_drift(fresh)))
