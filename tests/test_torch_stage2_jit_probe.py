"""The port's ``ResNetCM`` train-mode gradient against the JAX package's
eager gradient and against central differences, and a probe of the JAX
package's jitted gradient, which disagrees with both on XLA:CPU
(ROADMAP.md section 4).

ResNetCM at ``layers=(1, 1, 1)``, 33x33, spq 2, B=2, an all-ones prior,
batch-statistics BN, the loss a fixed random projection of the output.
The test (float64, the port alone): the directional derivative along a
random direction of ``layer2.0.conv3`` equals central differences of the
port's forward within 1e-6 of that gradient's norm.

    JAX_PLATFORMS=cpu PYTHONPATH=. \
        python tests/test_torch_stage2_jit_probe.py [--x64]

prints, per parameter group, the jitted gradient's largest error relative
to the eager one's largest magnitude, the port's, and (with ``--x64``)
the directional derivatives along the jitted-minus-eager direction of
``layer2_0/conv3``: central differences, the port, eager and jitted JAX.
"""

import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.models import backbones as jax_backbones
from pemp_tpu_torch.models.backbones import ResNetCM
from pemp_tpu_torch.utils.convert import state_dict_from_jax

SPQ, B, HW = 2, 2, 33
CONV3 = ("layer2_0", "conv3", "Conv_0", "kernel")


def _setup(x64, port_dtype=None):
    """The JAX model, its params, the loss, and the port loaded with the
    same weights (float32 values on both sides), in the JAX dtype or in
    ``port_dtype``."""
    dt, tdt = (jnp.float64, torch.float64) if x64 else (jnp.float32,
                                                         torch.float32)
    tdt = port_dtype or tdt
    rng = np.random.RandomState(3)
    prior = np.ones((B * SPQ, HW, HW, 1))
    x = np.concatenate([rng.randn(B * SPQ, HW, HW, 3), prior], -1)
    x, prior = x.astype(dt), prior.astype(dt)
    model = jax_backbones.ResNetCM((1, 1, 1), spq=SPQ, dtype=dt)
    variables = jax.jit(lambda k: model.init({"params": k}, (x, prior),
                                             False))(jax.random.PRNGKey(1))
    f32 = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                 variables["params"])
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), f32)
    stats = variables["batch_stats"]
    proj = rng.randn(B * SPQ, 5, 5, 1024).astype(dt)

    def loss(p):
        out, _ = model.apply({"params": p, "batch_stats": stats}, (x, prior),
                             True, mutable=["batch_stats"])
        return (out * proj).sum()

    sd = state_dict_from_jax({"backbone": f32}, {"backbone": jax.tree_util
                                                .tree_map(np.array, stats)})
    port = ResNetCM((1, 1, 1))
    port.load_state_dict({k[len("encoder.backbone."):]: v
                          for k, v in sd.items()})
    port = port.to(tdt).train()
    t = [torch.from_numpy(np.asarray(a)).to(tdt) for a in (x, prior, proj)]

    def port_loss():
        return (port(t[0].permute(0, 3, 1, 2), t[1].permute(0, 3, 1, 2),
                     SPQ).permute(0, 2, 3, 1) * t[2]).sum()

    return loss, params, port, port_loss


def _eager(loss, params):
    with jax.default_matmul_precision("highest"), jax.disable_jit():
        return jax.grad(loss)(params)


def _weights(grads_tree):
    """JAX gradient tree -> {port key: float32 tensor}, weights only."""
    sd = state_dict_from_jax({"backbone": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), grads_tree)}, {})
    return {k[len("encoder.backbone."):]: v for k, v in sd.items()
            if k.endswith("weight")}


def _central(port, port_loss, d, eps=1e-6):
    par = port.layer2[0].conv3.weight
    w0 = par.detach().clone()
    with torch.no_grad():
        sides = []
        for sign in (1, -1):
            par.copy_(w0 + sign * eps * d)
            sides.append(float(port_loss()))
        par.copy_(w0)
    return (sides[0] - sides[1]) / (2 * eps)


def test_resnet_cm_train_gradient_matches_central_differences():
    """float64: along a random direction of ``layer2.0.conv3`` the port's
    directional derivative equals central differences of its forward to
    within 1e-6 of the gradient's norm (the eager JAX gradient is held
    against the port in tests/test_torch_stage2_train_parity.py)."""
    _, _, port, port_loss = _setup(x64=False, port_dtype=torch.float64)
    port_loss().backward()
    grad = port.layer2[0].conv3.weight.grad
    d = torch.randn(grad.shape, generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    d /= d.norm()
    autograd = float((grad * d).sum())
    assert abs(_central(port, port_loss, d) - autograd) <= 1e-6 * grad.norm()


def main(x64):
    jax.config.update("jax_enable_x64", x64)
    loss, params, port, port_loss = _setup(x64)
    with jax.default_matmul_precision("highest"):
        jitted = jax.jit(jax.grad(loss))(params)
    eager = _eager(loss, params)
    port_loss().backward()

    def rel(a, want):
        a, want = np.asarray(a, np.float64), np.asarray(want, np.float64)
        return float(np.abs(a - want).max() / max(np.abs(want).max(), 1e-30))

    print(f"{'float64' if x64 else 'float32'}: error / max |eager grad|")
    for name in ("cm1", "cm2", "cm3", "layer1_0", "layer2_0", "layer3_0"):
        pick = (lambda t: t["linear"]["kernel"]) if name.startswith("cm") \
            else (lambda t: t)
        worst = max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            rel, pick(jitted[name]), pick(eager[name]))))
        print(f"  {name:9s} jitted {worst:.3e}")
    grads = dict(port.named_parameters())
    worst = max((rel(grads[k].grad.numpy(), v.numpy()), k)
                for k, v in _weights(eager).items())
    # the CM linears' biases are left out: the train-mode BNs after them
    # remove a batch-wide constant, so their gradient is zero in exact
    # arithmetic
    print(f"  port, worst weight {worst[1]}: {worst[0]:.3e}")
    if not x64:
        return

    def get(tree):
        return torch.from_numpy(np.asarray(
            tree[CONV3[0]][CONV3[1]][CONV3[2]][CONV3[3]]).transpose(3, 2, 0, 1)
            .copy())

    d = get(jitted) - get(eager)
    d /= d.norm()
    print("  layer2_0/conv3 directional derivative along jitted - eager:")
    print(f"    central differences {_central(port, port_loss, d):.9f}")
    autograd = float((grads["layer2.0.conv3.weight"].grad * d).sum())
    print(f"    port autograd       {autograd:.9f}")
    for name, tree in (("eager JAX", eager), ("jitted JAX", jitted)):
        print(f"    {name:19s} {float((get(tree) * d).sum()):.9f}")


if __name__ == "__main__":
    main("--x64" in sys.argv)
