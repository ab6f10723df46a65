"""The port's train-levers tool (``pemp_tpu_torch/tools/exp_train_levers.py``)
against the JAX tool (``tools/exp_train_levers.py``).

- ``S2BConv2d``'s space-to-batch schedule equals the JAX tool's
  ``s2b_impl`` on the same numpy NHWC inputs at float64, for d in
  {2, 4, 6, 12} at H, W in {13, 51}: max abs error <= 1e-10; its input
  and weight gradients equal those of the native dilated ``F.conv2d``
  (float64, <= 1e-10).
- ``WGrad32Conv2d``'s weight gradient is ``conv2d_weight`` on float32
  operands (bit for bit, under bf16 autocast and without), its input
  gradient the native one.
- The module swaps keep every parameter object and ``state_dict`` key.
- ``verify`` passes on the CPU at 33x33, float32, with the JAX tool's
  gate, and the gate refuses a perturbed step.
"""

from argparse import Namespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pemp_tpu_torch.tools import exp_train_levers as levers
from pemp_tpu_torch.tools.profile_train import flagship_setup
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401
from tools import exp_train_levers as jax_levers

TOL = 1e-10


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _conv_inputs(seed, n, c, co, h, w, bias=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c)                       # NHWC
    k = rng.randn(3, 3, c, co) / np.sqrt(9 * c)     # HWIO
    b = rng.randn(co) if bias else None
    return x, k, b


def _torch(x, k, b):
    """NHWC / HWIO numpy -> NCHW / OIHW float64 tensors."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    wt = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()
    bt = None if b is None else torch.from_numpy(b)
    return xt, wt, bt


@pytest.mark.parametrize("hw", [13, 51])
@pytest.mark.parametrize("d", [2, 4, 6, 12])
def test_s2b_equals_the_jax_s2b_impl(x64, d, hw):
    x, k, b = _conv_inputs(d + hw, 2, 5, 4, hw, hw + 2)
    want = np.asarray(jax_levers.s2b_impl(
        jnp.asarray(x), jnp.asarray(k), (1, 1), ((d, d), (d, d)), (d, d)))
    want = want + b                          # the JAX hook adds the bias
    xt, wt, bt = _torch(x, k, b)
    got = levers.s2b_conv2d(xt, wt, bt, d).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL
    native = F.conv2d(xt, wt, bt, padding=d, dilation=d)
    assert np.abs(native.permute(0, 2, 3, 1).numpy() - want).max() <= TOL


@pytest.mark.parametrize("hw", [13, 51])
@pytest.mark.parametrize("d", [2, 4, 6, 12])
def test_s2b_gradients_equal_the_dilated_conv(d, hw):
    x, k, b = _conv_inputs(100 + d + hw, 2, 3, 4, hw, hw - 1)
    xt, wt, bt = _torch(x, k, b)
    r = torch.from_numpy(np.random.RandomState(d).randn(2, 4, hw, hw - 1))
    grads = []
    for fn in (lambda a, w, c: levers.s2b_conv2d(a, w, c, d),
               lambda a, w, c: F.conv2d(a, w, c, padding=d, dilation=d)):
        leaves = [t.clone().requires_grad_() for t in (xt, wt, bt)]
        (fn(*leaves) * r).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert (got - want).abs().max().item() <= TOL


def test_s2b_module_keeps_the_layout_and_parameters():
    conv = torch.nn.Conv2d(6, 4, 3, padding=2, dilation=2)
    s2b = levers.S2BConv2d(conv)
    assert s2b.weight is conv.weight and s2b.bias is conv.bias
    x = torch.randn(2, 6, 11, 9).to(memory_format=torch.channels_last)
    y = s2b(x)
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y, conv(x), rtol=1e-5, atol=1e-5)
    for bad in (torch.nn.Conv2d(6, 4, 3, padding=1),
                torch.nn.Conv2d(6, 4, 3, padding=2, dilation=2, stride=2),
                torch.nn.Conv2d(6, 4, 1, dilation=2)):
        assert not levers.s2b_eligible(bad)
        with pytest.raises(ValueError):
            levers.S2BConv2d(bad)


@pytest.mark.parametrize("autocast", [False, True])
def test_wgrad32_weight_grad_is_conv2d_weight_in_float32(autocast):
    gen = torch.Generator().manual_seed(0)
    conv = torch.nn.Conv2d(4, 6, 3, padding=2, dilation=2)
    x = torch.randn(2, 4, 10, 12, generator=gen)
    r = torch.randn(2, 6, 10, 12, generator=gen)
    mod = levers.WGrad32Conv2d(conv)
    assert mod.weight is conv.weight
    xs = []
    for m in (mod, conv):
        m.weight.grad = m.bias.grad = None
        xi = x.clone().requires_grad_()
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
            y = m(xi)
        (y.float() * r).sum().backward()
        xs.append(xi.grad)
        if m is mod:
            got_dw, got_db, got_y = (conv.weight.grad.clone(),
                                     conv.bias.grad.clone(), y.detach())
    dtype = torch.bfloat16 if autocast else torch.float32
    g = r.to(dtype)
    want = torch.nn.grad.conv2d_weight(
        x.to(dtype).float(), conv.weight.shape, g.float(), 1, 2, 2,
        1).to(dtype).float()
    assert torch.equal(got_dw, want)
    assert torch.equal(got_db, g.sum((0, 2, 3)).float())
    assert torch.equal(xs[0], xs[1])            # dx as autograd gives it
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        assert torch.equal(got_y, conv(x))


def test_arms_swap_modules_sharing_the_parameters():
    device = torch.device("cpu")
    base = flagship_setup(33, 1, "ce", device, "f32").model
    keys = list(base.state_dict())
    for arm, want in (("s2b", 9), ("wgrad32", 51)):
        setup, swapped = levers.arm_setup(arm, Namespace(
            hw=33, bs=1, loss="ce", precision="f32"), device)
        assert swapped == want                  # layer3 d=2 x6, ASPPV2 x3
        assert list(setup.model.state_dict()) == keys
        params = {id(p) for p in setup.model.parameters()}
        opt = {id(p) for g in setup.trainer.optimizer.param_groups
               for p in g["params"]}
        assert opt <= params


def test_verify_passes_on_the_cpu_with_the_jax_gate():
    out = levers.main(["verify", "--device", "cpu", "--hw", "33", "--bs",
                       "2"])
    assert out["verify"] == "ok" and out["platform"] == "cpu"
    assert set(out["results"]) == {"s2b", "wgrad32"}
    for r in out["results"].values():
        assert r["worst_param_rel"] < 5e-3
        assert 0 <= r["worst_grad_rel"] < 1e-3     # f32 sums reordered
        assert abs(r["loss"] - out["native_loss"]) <= 2e-3 * abs(
            out["native_loss"])


def test_the_gate_refuses_a_wrong_step():
    rng = np.random.RandomState(0)
    base = {"a": rng.randn(8), "b": 1e-3 * rng.randn(4)}
    ok = {k: v * (1 + 1e-6) for k, v in base.items()}
    assert levers.gate(1.0, base, 1.0, ok, False, "ok") < 5e-3
    bad = dict(base, b=base["b"] + 1e-4)
    with pytest.raises(AssertionError, match="post-step"):
        levers.gate(1.0, base, 1.0, bad, False, "bad")
    with pytest.raises(AssertionError, match="loss"):
        levers.gate(1.0, base, 1.01, ok, False, "bad")
    # on the card the bound is relative to 1e-2 of the global scale
    assert levers.gate(1.0, base, 1.01, bad, True, "card") < 2e-2


def test_grad_gap_sees_a_wrong_gradient_the_gate_passes():
    """One step's update is small beside the weights: a gradient off by
    half passes the card's gate on the post-step weights, and
    ``grad_gap`` reads it."""
    rng = np.random.RandomState(1)
    w0 = {"a": rng.randn(8), "b": rng.randn(4), "frozen": rng.randn(3)}
    g = {"a": rng.randn(8), "b": rng.randn(4), "frozen": np.zeros(3)}
    lr = 1e-3
    base = {k: w0[k] - lr * g[k] for k in w0}
    wrong = dict(base, b=w0["b"] - 0.5 * lr * g["b"])
    assert levers.gate(1.0, base, 1.0, wrong, True, "card") < 2e-2
    assert levers.grad_gap(g, g) == 0.0
    assert levers.grad_gap(g, dict(g, b=0.5 * g["b"])) == pytest.approx(0.5)
    assert levers.grad_gap(g, {"a": g["a"]}) == 1.0       # b missing


def test_show_wgrad_dtypes_reads_bf16_operands():
    rows = levers.main(["show_wgrad_dtypes", "--device", "cpu"])
    assert rows and all(v == "torch.bfloat16" for r in rows
                        for k, v in r.items() if k != "node")
