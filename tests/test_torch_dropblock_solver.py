"""The port's DropBlock (``ops/dropblock.py``, ``models/layers.py``) and
solver (``core/solver.py``) against the JAX package on the same inputs.

- ``dropblock_mask`` fed the uniforms JAX's ``dropblock_2d`` draws drops
  exactly the same pixels, and the kept values agree within rtol 1e-6
  (XLA may fold ``x * mask * scale`` in another order: one ulp);
- ``LRPolicy`` equals ``pemp_tpu.core.solver.LRPolicy`` step for step
  for all five policies (exact: the same float64 arithmetic);
- clipped SGD steps with a frozen BN equal ``make_optimizer`` +
  ``apply_updates`` within rtol 1e-6 (float32 sums in another order).
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.core import solver as jax_solver
from pemp_tpu.ops.dropblock import dropblock_2d as jax_dropblock
from pemp_tpu_torch.core import solver
from pemp_tpu_torch.models.layers import DropBlock
from pemp_tpu_torch.ops.dropblock import dropblock_2d, dropblock_mask


@pytest.mark.parametrize("block_size", [4, 3])
def test_dropblock_mask_equals_jax(block_size):
    n, h, w, c = 3, 17, 21, 5
    x = np.random.RandomState(block_size).randn(n, h, w, c).astype(np.float32)
    key = jax.random.PRNGKey(block_size)
    uniform = np.array(jax.random.uniform(key, (n, h, w)))
    want = np.asarray(jax_dropblock(key, jnp.asarray(x), 0.3, block_size))
    mask, scale = dropblock_mask(torch.from_numpy(uniform), 0.3, block_size)
    got = (torch.from_numpy(x) * (mask * scale)[..., None]).numpy()
    assert mask.shape == (n, h, w) and 0 < mask.mean() < 1
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_dropblock_module_modes_and_generator():
    block = DropBlock(0.3, 4)
    x = torch.ones(2, 6, 16, 16)
    assert block.eval()(x) is x
    block.train()
    block.generator = torch.Generator().manual_seed(3)
    a = block(x)
    block.generator = torch.Generator().manual_seed(3)
    b = block(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    dropped = a == 0
    assert dropped.any()
    assert (dropped.all(dim=1) == dropped.any(dim=1)).all()   # all channels
    assert DropBlock(0.0, 4).train()(x) is x
    assert dropblock_2d(x, 0.0, 4) is x


def _tr_cfg(lrp, **kw):
    base = dict(lr=0.01, lrp=lrp, lr_boundaries=[2, 4], lr_step=2,
                lr_rate=0.5, lr_end=1e-4, lr_patience=1, lr_min_delta=1e-4,
                cool_down=1, power=0.9, opt="sgd", sgd_momentum=0.9,
                sgd_nesterov=False, weight_decay=5e-4, grad_clip=1.1,
                adam_beta1=0.9, adam_beta2=0.999, adam_epsilon=1e-8)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("lrp", ["period_step", "custom_step", "plateau",
                                 "cosine", "poly"])
def test_lr_policy_step_for_step(lrp):
    cfg = _tr_cfg(lrp)
    ours, ref = solver.LRPolicy(cfg, 12), jax_solver.LRPolicy(cfg, 12)
    monitor = [1.0, 0.9, 0.95, 0.97, 0.99, 0.5]
    seen = []
    for epoch in range(6):
        for _ in range(2):
            assert ours.lr == ref.lr
            seen.append(ours.lr)
            ours.step_step()
            ref.step_step()
        ours.step_epoch(monitor_value=monitor[epoch])
        ref.step_epoch(monitor_value=monitor[epoch])
        assert ours.state_dict() == ref.state_dict()
    assert len(set(seen)) > 1, f"{lrp} never changed the rate"
    again = solver.LRPolicy(cfg, 12)
    again.load_state_dict(ours.state_dict())
    assert again.lr == ours.lr and again.state_dict() == ours.state_dict()


class _Net(torch.nn.Module):
    """A conv, a BN that stays frozen and a second conv: the frozen-BN
    rule in miniature."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.bn = torch.nn.BatchNorm2d(4)
        self.head = torch.nn.Conv2d(4, 2, 1)

    def forward(self, x):
        return self.head(torch.relu(self.bn(self.conv(x))))


@pytest.mark.parametrize("nesterov", [False, True])
def test_clipped_sgd_with_frozen_bn_equals_optax(nesterov):
    torch.manual_seed(0)
    net = _Net()
    with torch.no_grad():
        net.bn.weight.uniform_(0.5, 1.5)
        net.bn.bias.uniform_(-0.2, 0.2)
    for p in net.bn.parameters():
        p.requires_grad_(False)
    cfg = _tr_cfg("poly", sgd_nesterov=nesterov, grad_clip=0.5)
    trainable = [p for p in net.parameters() if p.requires_grad]
    opt = solver.make_optimizer(cfg, trainable)
    policy = solver.LRPolicy(cfg, 3)

    # copies: a jnp array may alias the numpy view of a torch tensor,
    # which the torch optimizer then updates in place
    params = {k: jnp.array(v.detach().numpy(), copy=True)
              for k, v in net.named_parameters()}
    mask = {k: not k.startswith("bn.") for k in params}
    tx = jax_solver.make_optimizer(cfg, mask)
    state = tx.init(params)
    ref_policy = jax_solver.LRPolicy(cfg, 3)

    rng = np.random.RandomState(1)
    for _ in range(3):
        x = torch.from_numpy(rng.randn(2, 3, 8, 8).astype(np.float32))
        target = torch.from_numpy(rng.randn(2, 2, 8, 8).astype(np.float32))
        opt.zero_grad(set_to_none=True)
        ((net(x) - target) ** 2).mean().backward()
        grads = {k: jnp.array(p.grad.numpy(), copy=True)
                 if p.grad is not None
                 else jnp.zeros(p.shape) for k, p in net.named_parameters()}
        assert math.sqrt(sum(float((g ** 2).sum()) for g in grads.values())) \
            > cfg.grad_clip, "the step must clip"
        solver.clip_gradients(trainable, cfg.grad_clip)
        solver.set_lr(opt, policy.lr)
        opt.step()
        updates, state = tx.update(grads, state, params)
        params = jax_solver.apply_updates(params, updates, ref_policy.lr)
        policy.step_step()
        ref_policy.step_step()
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert torch.equal(net.bn.weight.detach(), torch.from_numpy(
        np.array(params["bn.weight"])))


def test_adam_is_built_and_unknown_optimizers_refused():
    p = [torch.nn.Parameter(torch.ones(3))]
    assert isinstance(solver.make_optimizer(_tr_cfg("poly", opt="adam"), p),
                      torch.optim.Adam)
    with pytest.raises(ValueError):
        solver.make_optimizer(_tr_cfg("poly", opt="lamb"), p)
