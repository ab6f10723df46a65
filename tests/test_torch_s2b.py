"""The models' space-to-batch route for dilated 3x3 convolutions
(``pemp_tpu_torch/ops/s2b.py``, ``models/layers.py::Conv``) on the CPU:

- a routed ``Conv`` (d in {12, 18}, H, W in {13, 51}, N in {1, 3}) equals
  ``F.conv2d`` at the same dilation at float64 in its output, input
  gradient, weight gradient and bias gradient (max abs error <= 1e-10),
  and keeps the memory format (channels-last in, channels-last out; NCHW
  in, NCHW out); under bf16 autocast it is within two bf16 ulps of the
  dilated convolution;
- the route is chosen from the module's own shape at construction:
  d = 2, 4 and 6, strides, groups, other paddings and kernels do not
  route (``s2b_calls`` stays empty); ``KaimingConv`` and ``NormalConv``
  route as ``Conv`` does;
- parameters and ``state_dict`` keys are ``nn.Conv2d``'s: ASPPV2 and
  ASPP load the reference layout (``tests/torch_mirrors.py``) strictly
  and give its outputs;
- ``s2b_calls`` counts one call a routed forward: ASPPV2 and stage 2's
  PurifierV1 ASPP give {12: 1, 18: 1} a forward, and ``profile_eval`` /
  ``profile_train`` print the calls of their window;
- ``utils/profiling.py::conv_by_shape`` books the route's dense
  convolution, forward and backward, under the dilation it computes.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pemp_tpu_torch.models.common import PurifierV1, PurifierV2
from pemp_tpu_torch.models.layers import (
    ASPP, ASPPV2, Conv, KaimingConv, NormalConv,
)
from pemp_tpu_torch.ops import s2b
from pemp_tpu_torch.tools import profile_eval, profile_train
from pemp_tpu_torch.utils import profiling
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401
from tests.torch_mirrors import TorchASPP, TorchASPPV2

TOL = 1e-10
CL = torch.channels_last


@pytest.fixture(autouse=True)
def fresh_counts():
    s2b.reset_s2b_calls()
    yield
    s2b.reset_s2b_calls()


def _grads(fn, leaves, r):
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    y = fn(*leaves)
    (y * r).sum().backward()
    return y, [t.grad for t in leaves]


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("w", [13, 51])
@pytest.mark.parametrize("h", [13, 51])
@pytest.mark.parametrize("d", [12, 18])
def test_routed_conv_equals_the_dilated_conv(d, h, w, n):
    gen = torch.Generator().manual_seed(d * 1000 + h * 10 + w + n)
    conv = Conv(6, 5, 3, padding=d, dilation=d).double()
    assert conv.s2b_dilation == d
    x = torch.randn(n, 6, h, w, generator=gen,
                    dtype=torch.float64).to(memory_format=CL)
    r = torch.randn(n, 5, h, w, generator=gen, dtype=torch.float64)
    xg = x.clone().requires_grad_()
    got = conv(xg)
    (got * r).sum().backward()
    got_g = (xg.grad, conv.weight.grad, conv.bias.grad)
    want, want_g = _grads(lambda a, wt, b: F.conv2d(a, wt, b, padding=d,
                                                    dilation=d),
                          (x, conv.weight, conv.bias), r)
    assert s2b.s2b_calls == {d: 1}
    assert got.is_contiguous(memory_format=CL)
    assert (got - want).abs().max().item() <= TOL
    for g, e in zip(got_g, want_g):
        assert g.shape == e.shape and (g - e).abs().max().item() <= TOL
    nchw = conv(x.contiguous())
    assert nchw.is_contiguous()
    assert (nchw - want).abs().max().item() <= TOL


@pytest.mark.parametrize("d", [12, 18])
def test_routed_conv_under_bf16_autocast(d):
    """The gather casts as the convolution would: bf16 out, within two
    bf16 ulps (2^-7) of the largest magnitude of the dilated conv."""
    gen = torch.Generator().manual_seed(d)
    conv = Conv(16, 8, 3, padding=d, dilation=d)
    x = torch.randn(2, 16, 51, 47, generator=gen).to(memory_format=CL)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = conv(x)
        want = F.conv2d(x, conv.weight, conv.bias, padding=d, dilation=d)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=CL)
    diff = (got.float() - want.float()).abs().max()
    assert diff <= 2.0 ** -7 * want.float().abs().max()


@pytest.mark.parametrize("d", [2, 4, 6])
def test_smaller_dilations_do_not_route(d):
    conv = Conv(4, 4, 3, padding=d, dilation=d)
    assert conv.s2b_dilation == 0
    conv(torch.randn(1, 4, 51, 51))
    assert s2b.s2b_calls == {}


def test_the_route_is_chosen_from_the_module_shape():
    for conv in (Conv(4, 4, 3, padding=12, dilation=12, stride=2),
                 Conv(4, 4, 3, padding=12, dilation=12, groups=2),
                 Conv(4, 4, 3, padding=6, dilation=12),
                 Conv(4, 4, 3, padding=12, dilation=12,
                      padding_mode="reflect"),
                 Conv(4, 4, 1, dilation=12),
                 Conv(4, 4, 3, padding=1)):
        assert conv.s2b_dilation == 0, conv
        conv(torch.randn(1, 4, 33, 33))
    assert s2b.s2b_calls == {}
    assert KaimingConv(4, 4, 3, padding=12, dilation=12).s2b_dilation == 12
    assert NormalConv(4, 4, 3, padding=18, dilation=18).s2b_dilation == 18
    assert isinstance(KaimingConv(4, 4, 1), Conv)


def test_parameters_and_keys_are_the_reference_layout():
    conv = Conv(4, 3, 3, padding=12, dilation=12)
    plain = torch.nn.Conv2d(4, 3, 3, padding=12, dilation=12)
    assert list(conv.state_dict()) == list(plain.state_dict())
    assert [id(p) for p in conv.parameters()] == [id(conv.weight),
                                                  id(conv.bias)]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 13, 13, generator=gen,
                    dtype=torch.float64).to(memory_format=CL)
    for port, ref in ((ASPPV2(16, 8, 4), TorchASPPV2(16, 8, 4)),
                      (ASPP(16, 8, 4), TorchASPP(16, 8, 4))):
        port, ref = port.double().eval(), ref.double().eval()
        assert list(port.state_dict()) == list(ref.state_dict())
        port.load_state_dict(ref.state_dict(), strict=True)
        s2b.reset_s2b_calls()
        got = port(x)
        assert s2b.s2b_calls == {12: 1, 18: 1}
        assert (got - ref(x)).abs().max().item() <= TOL


@pytest.mark.parametrize("make", [lambda: ASPPV2(16, 8, 4),
                                  lambda: PurifierV1(32, 4),
                                  lambda: PurifierV2(32, 4)])
def test_s2b_calls_count_one_call_a_routed_forward(make):
    model = make().eval()
    c = 16 if isinstance(model, ASPPV2) else 32
    x = torch.randn(1, c, 13, 13).to(memory_format=CL)
    for k in (1, 2):
        model(x)
        assert s2b.s2b_calls == {12: k, 18: k}
    before = dict(s2b.s2b_calls)
    model(x)
    assert s2b.s2b_calls_since(before) == {12: 1, 18: 1}
    s2b.reset_s2b_calls()
    assert s2b.s2b_calls == {}


def test_conv_by_shape_books_the_route_under_its_dilation():
    c6 = Conv(8, 8, 3, padding=6, dilation=6)
    c12 = Conv(8, 8, 3, padding=12, dilation=12)
    c18 = Conv(8, 8, 3, padding=18, dilation=18)
    x = torch.randn(2, 8, 13, 13).to(memory_format=CL).requires_grad_()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        (c6(x) + c12(x) + c18(x)).sum().backward()
    rows = profiling.conv_by_shape(prof, None)
    ops = {(r["op"], r["dilation"]) for r in rows}
    for d in (6, 12, 18):
        assert ("aten::conv2d", d) in ops
        assert ("aten::convolution_backward", d) in ops
    # the route's dense convolutions: the phase batch at padding 1
    for r in rows:
        if r["dilation"] in (12, 18):
            assert r["input_shapes"].startswith("[[")
            assert not r["input_shapes"].startswith("[[2, 8, 13, 13]")


def test_profile_tools_print_the_route_calls():
    out = profile_eval.main(["--device", "cpu", "--hw", "33", "--batch",
                             "1", "--launches", "2"])
    assert out["s2b_calls"] == {12: 2, 18: 2}
    out = profile_train.main(["--device", "cpu", "--hw", "33", "--bs", "1",
                              "--steps", "2", "--loss", "ce"])
    assert out["s2b_calls"] == {12: 2, 18: 2}
    assert np.isfinite(out["wall_ms_per_step"])
