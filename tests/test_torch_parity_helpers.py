"""Helpers the port's parity tests share (no tests of its own): JAX
variables drawn from numpy, float64 trees carried into the port's
``state_dict``, the per-leaf comparison at a tolerance relative to each
leaf's largest magnitude, one train step on each side, and a fixture
that runs a module's torch on one thread.
"""

import numpy as np
import pytest
import torch

import jax
from flax import traverse_util

from pemp_tpu_torch.utils.convert import state_dict_from_jax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread for the module that imports this fixture: at
    toy sizes one thread is as fast, and the suite's parallel workers
    would otherwise oversubscribe the cores (each worker's torch starts
    one thread a core)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tree64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


def sd64(params, stats):
    """``state_dict_from_jax`` of float64 trees, kept at float64: the sum
    of the float32 mappings of a high and a low part."""
    hi_p = jax.tree_util.tree_map(np.float32, tree64(params))
    hi_s = jax.tree_util.tree_map(np.float32, tree64(stats))
    lo_p = jax.tree_util.tree_map(lambda x, h: np.float32(x - h),
                                  tree64(params), hi_p)
    lo_s = jax.tree_util.tree_map(lambda x, h: np.float32(x - h),
                                  tree64(stats), hi_s)
    hi, lo = state_dict_from_jax(hi_p, hi_s), state_dict_from_jax(lo_p, lo_s)
    return {k: hi[k].double() + lo[k].double() for k in hi
            if not k.endswith("num_batches_tracked")}


def assert_leaves_close(got, want, rel, what):
    """Every leaf of ``want``: max abs error <= ``rel`` of the larger of the
    two sides' largest magnitude."""
    bad = []
    for k in sorted(want):
        g = got[k].double().numpy()
        w = np.asarray(want[k].double() if torch.is_tensor(want[k])
                       else want[k], np.float64)
        scale = max(np.abs(w).max(), np.abs(g).max(), 1e-10)
        err = np.abs(g - w).max() / scale
        if err > rel:
            bad.append((k, float(err)))
    assert not bad, f"{what} mismatch on {len(bad)} leaves: {bad[:8]}"


def draw_variables(model, args, seed, **kwargs):
    """float32 trees drawn from numpy at the init's scales (shapes from
    ``eval_shape``: no init compute): conv kernels N(0, 2 / fan_in),
    dense kernels U(+-1/sqrt(fan_in)), small biases, ``ctr`` U[0, 1),
    every BN's affine and running statistics randomised."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, *args, **kwargs))
    rng = np.random.RandomState(seed + 10)

    def draw(path, leaf):
        name, shape = path[-1], leaf.shape
        if path[-2:-1] == ("BatchNorm_0",):
            x = (rng.uniform(0.5, 1.5, shape) if name == "scale"
                 else 0.1 * rng.randn(*shape))
        elif name == "ctr":
            x = rng.uniform(0.0, 1.0, shape)
        elif name == "kernel" and len(shape) == 4:
            x = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:3]))
        elif name == "kernel":
            x = rng.uniform(-1, 1, shape) / np.sqrt(shape[0])
        else:
            x = 0.01 * rng.randn(*shape)
        return x.astype(np.float32)

    def stat(path, leaf):
        return (0.1 * rng.randn(*leaf.shape) if path[-1] == "mean"
                else rng.uniform(0.5, 1.5, leaf.shape)).astype(np.float32)

    def fill(f, tree):
        return traverse_util.unflatten_dict(
            {k: f(k, v) for k, v in traverse_util.flatten_dict(tree).items()})

    return (fill(draw, shapes["params"]),
            fill(stat, shapes.get("batch_stats", {})))


def episode(seed, b, s, q, h, w, dtype=np.float64):
    """Support images, [fg, bg] masks and query images from numpy."""
    rng = np.random.RandomState(seed)
    sup = rng.randn(b, s, h, w, 3).astype(dtype)
    fg = (rng.rand(b, s, h, w, 1) > 0.5).astype(dtype)
    qry = rng.randn(b, q, h, w, 3).astype(dtype)
    return sup, np.concatenate([fg, 1 - fg], -1), qry


def jax_sgd_step(loss_fn, params, frozen, tr_cfg):
    """One jitted JAX train step at HIGHEST matmul precision: ``loss_fn(p)
    -> (loss, new batch_stats)``; returns (loss, grads, new batch_stats,
    the params after the package's optimizer with the ``frozen``
    patterns masked out)."""
    from pemp_tpu.core import solver as jax_solver
    with jax.default_matmul_precision("highest"):
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        tx = jax_solver.make_optimizer(tr_cfg, jax_solver.trainable_mask(
            params, frozen))
        updates, _ = tx.update(grads, tx.init(params), params)
        new = jax_solver.apply_updates(params, updates, tr_cfg.lr)
    return float(loss), grads, stats, new


def assert_port_step_matches(port, loss_t, want, tr_cfg, rel,
                             zero_grads=()):
    """Backward of the port's ``loss_t`` and one step of the port's
    optimizer over ``port.freeze()``'s parameters, held against
    ``jax_sgd_step``'s ``want`` (loss, grads, stats, params): the loss,
    every trainable gradient, every BN running stat and every parameter
    after the step, each leaf within ``rel`` of its largest magnitude.
    ``zero_grads``: biases whose gradient is zero in exact arithmetic (a
    conv bias ahead of a train-mode BN, which removes it), held to zero on
    both sides within ``rel`` of their weight's largest gradient instead.
    Returns the names of the frozen parameters."""
    from pemp_tpu_torch.core import solver
    loss, grads, stats, new = want
    trained = port.freeze()
    opt = solver.make_optimizer(tr_cfg, trained)
    opt.zero_grad(set_to_none=True)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), loss, rtol=rel)
    got = {k: p.grad for k, p in port.named_parameters() if p.requires_grad}
    frozen = {k for k, p in port.named_parameters() if not p.requires_grad}
    want_g = sd64(grads, {})
    assert set(got) | frozen == set(want_g)
    assert all(g is not None for g in got.values())
    for k in zero_grads:
        scale = rel * want_g[k.rsplit(".", 1)[0] + ".weight"].abs().max()
        assert got[k].abs().max() <= scale and want_g[k].abs().max() <= scale
    assert_leaves_close(got, {k: want_g[k] for k in got
                              if k not in zero_grads}, rel, "grad")
    solver.clip_gradients(trained, tr_cfg.grad_clip)
    opt.step()
    # the params tree tells the layout: carry the stats beside it
    after = sd64(new, stats)
    state = port.state_dict()
    running = {k for k in after if ".running_" in k}
    assert running and set(after) == {k for k in state
                                      if not k.endswith("_tracked")}
    assert_leaves_close({k: state[k] for k in running},
                        {k: after[k] for k in running}, rel, "running stats")
    assert_leaves_close({k: p.detach() for k, p in port.named_parameters()},
                        {k: after[k] for k in after if k not in running}, rel,
                        "sgd step")
    return frozen
