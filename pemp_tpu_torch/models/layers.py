"""Building blocks with the reference's PyTorch conventions.

Counterpart of ``pemp_tpu/models/layers.py``. The JAX package rebuilt
torch's conventions on NHWC Flax modules; here they are torch's own:

- ``Conv`` is ``nn.Conv2d`` (default init: kaiming-uniform with a=sqrt(5),
  bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)));
- ``BatchNorm`` is ``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``, which is the
  semantics ``_TorchBatchNorm`` reproduces in JAX (running variance from
  the unbiased batch variance, two-pass batch statistics);
- ``KaimingConv`` is ``nn.Conv2d`` drawn kaiming-normal (relu gain,
  fan_in) by ``FewShotModel.reset_parameters``: the VGG16 convs'
  ``kaiming_normal_relu`` init; ``NormalConv`` is drawn from
  normal(0, 0.01), CaNet's head init;
- ``max_pool_torch`` is ``nn.MaxPool2d(3, 2, 1, ceil_mode=True)`` for the
  ResNet stem; VGG16 and PFENet's deep-base stem pool with
  ``nn.MaxPool2d(3, stride, 1)`` (floor mode), which differs from it at
  even sizes;
- ``Dropout2d`` and ``DropBlock`` draw from an explicit generator (set by
  the trainer), which ``nn.Dropout2d`` cannot take; in a world of several
  processes each draws the mask of the global batch and keeps its own
  rows (``shard``, a ``parallel.mesh.RowShard``), the masks one process
  would draw;
- ``GlobalBatchNorm`` replaces ``BatchNorm`` in a world of several
  processes (``global_batchnorm``): train-mode statistics over the global
  batch, as under the JAX package's mesh.

Modules take NCHW tensors; the models keep them in
``torch.channels_last`` memory, the layout of the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pemp_tpu_torch.ops.dropblock import dropblock_2d
from pemp_tpu_torch.parallel import mesh

Conv = nn.Conv2d
BatchNorm = nn.BatchNorm2d      # defaults eps=1e-5, momentum=0.1


class KaimingConv(nn.Conv2d):
    """A ``Conv`` whose weight ``FewShotModel.reset_parameters`` draws
    kaiming-normal (relu gain, fan_in) instead of torch's default
    (the JAX package's ``kaiming_normal_relu``); its bias keeps torch's
    U(+-1/sqrt(fan_in))."""


class NormalConv(nn.Conv2d):
    """A ``Conv`` whose weight ``FewShotModel.reset_parameters`` draws from
    normal(0, 0.01) (CaNet's head and the residual blocks RPMMs shares
    with it: the JAX package's ``canet_normal_init``); its bias keeps
    torch's U(+-1/sqrt(fan_in))."""

    STD = 0.01


def max_pool_torch() -> nn.MaxPool2d:
    return nn.MaxPool2d(3, 2, 1, ceil_mode=True)


class DropBlock(nn.Module):
    """DropBlock2D (``ops/dropblock.py``): the identity in eval mode and at
    rate 0. In train mode it draws from ``self.generator`` (set by the
    trainer, one per epoch; None draws from PyTorch's default)."""

    def __init__(self, rate: float, block_size: int):
        super().__init__()
        self.rate = rate
        self.block_size = block_size
        self.generator: Optional[torch.Generator] = None
        self.shard: Optional[mesh.RowShard] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        return dropblock_2d(x, self.rate, self.block_size, self.generator,
                            self.shard)


class Dropout2d(nn.Module):
    """Channel dropout (``nn.Dropout2d``; the JAX package's ``nn.Dropout``
    with ``broadcast_dims=(1, 2)``): in train mode each (image, channel)
    map is zeroed with probability ``rate`` and the rest scaled by
    1 / (1 - rate); the identity in eval mode and at rate 0. Draws from
    ``self.generator`` like ``DropBlock``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.shard: Optional[mesh.RowShard] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        n, c = x.shape[:2]
        world = 1 if self.shard is None else self.shard.world
        keep = torch.rand((n * world, c, 1, 1), generator=self.generator,
                          device=x.device) >= self.rate
        if self.shard is not None:
            keep = self.shard.local(keep)
        return x / (1.0 - self.rate) * keep


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the world's batch (NCHW): the forward
    all-reduces the per-channel sum and count, then the sum of squared
    deviations (two passes, the JAX ``_TorchBatchNorm``); the backward
    all-reduces the sums of the gradient and of the gradient times the
    normalised input, torch's batch-norm backward over the global batch.
    Half-precision inputs are normalised in float32."""

    @staticmethod
    def forward(ctx, x, weight, bias, module):
        dims = (0, 2, 3)
        xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
        count = xf.new_full((1,), x.numel() // x.shape[1])
        stats = mesh.all_reduce_sum(torch.cat([xf.sum(dims), count]))
        n = stats[-1]
        mean = stats[:-1] / n
        xc = xf - mean[None, :, None, None]
        var = mesh.all_reduce_sum((xc * xc).sum(dims)) / n
        invstd = torch.rsqrt(var + module.eps)
        xhat = xc * invstd[None, :, None, None]
        y = xhat
        if weight is not None:
            y = xhat * weight[None, :, None, None].to(xhat.dtype) \
                + bias[None, :, None, None].to(xhat.dtype)
        if module.track_running_stats:
            m = module.momentum
            module.num_batches_tracked.add_(1)
            module.running_mean.mul_(1 - m).add_(m * mean)
            module.running_var.mul_(1 - m).add_(m * var * n / (n - 1))
        ctx.save_for_backward(xhat, weight, invstd, n)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, grad_y):
        xhat, weight, invstd, n = ctx.saved_tensors
        dims = (0, 2, 3)
        g = grad_y.to(xhat.dtype)
        sum_dy = g.sum(dims)
        sum_dy_xhat = (g * xhat).sum(dims)
        grad_x = grad_w = grad_b = None
        if ctx.needs_input_grad[0]:
            c = sum_dy.shape[0]
            both = mesh.all_reduce_sum(torch.cat([sum_dy, sum_dy_xhat])) / n
            scale = invstd if weight is None else invstd * weight.to(g.dtype)
            grad_x = ((g - both[None, :c, None, None]
                       - xhat * both[None, c:, None, None])
                      * scale[None, :, None, None]).to(grad_y.dtype)
        # the parameters' local sums: DDP's mean over the ranks completes
        # them, as for every other parameter
        if weight is not None and ctx.needs_input_grad[1]:
            grad_w = sum_dy_xhat.to(weight.dtype)
        if weight is not None and ctx.needs_input_grad[2]:
            grad_b = sum_dy.to(weight.dtype)
        return grad_x, grad_w, grad_b, None


class GlobalBatchNorm(nn.BatchNorm2d):
    """``BatchNorm`` whose train-mode statistics span every process of the
    world (``_GlobalBatchNorm``); with one process, or in eval mode, it is
    ``BatchNorm``. Parameters, buffers and ``state_dict`` keys are
    ``BatchNorm``'s, so checkpoints load across world sizes."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or mesh.process_count() == 1:
            return super().forward(x)
        return _GlobalBatchNorm.apply(x, self.weight, self.bias, self)


def global_batchnorm(model: nn.Module) -> nn.Module:
    """Every ``BatchNorm`` of ``model`` becomes a ``GlobalBatchNorm`` in
    place (the same parameters and buffers): its batch statistics in train
    mode are the world's, as one process would take them over the global
    batch. ``torch.nn.SyncBatchNorm`` does the same on CUDA only."""
    for m in model.modules():
        if type(m) is BatchNorm:
            m.__class__ = GlobalBatchNorm
    return model


class ASPP(nn.Module):
    """ASPP with channel dropout after each branch (reference
    networks/backbones.py:279-321; ``pemp_tpu/models/layers.py:231-262``):
    a global-pool branch (1x1 conv, ReLU, Dropout2d, broadcast), a 1x1
    branch and 3x3 branches at dilation 6, 12 and 18, then the ``layer6``
    1x1 tail; without the ``tail`` it returns the 5 x ``midc`` channel
    concatenation (RPMMs). Keys follow the reference: ``aspp_k.0`` conv,
    ``layer6``."""

    def __init__(self, inc: int = 256, midc: int = 256, outc: int = 512,
                 drop_rate: float = 0.5, tail: bool = True):
        super().__init__()
        for k, (ksize, dil) in enumerate([(1, 1), (1, 1), (3, 6), (3, 12),
                                          (3, 18)]):
            pad = dil if ksize == 3 else 0
            setattr(self, f"aspp_{k}", nn.Sequential(
                Conv(inc, midc, ksize, padding=pad, dilation=dil), nn.ReLU(),
                Dropout2d(drop_rate)))
        self.layer6 = Conv(5 * midc, outc, 1) if tail else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        g = self.aspp_0(x.mean(dim=(2, 3), keepdim=True))
        g = g.expand(-1, -1, h, w)
        out = torch.cat([g, self.aspp_1(x), self.aspp_2(x), self.aspp_3(x),
                         self.aspp_4(x)], dim=1)
        return out if self.layer6 is None else self.layer6(out)


class ASPPV2(nn.Module):
    """ASPP with BatchNorm + DropBlock before each branch conv (reference
    networks/backbones.py:324-369; ``pemp_tpu/models/layers.py:265-298``).
    Submodule names follow the reference's ``state_dict`` layout:
    ``aspp_k.0`` BN, ``aspp_k.2`` conv, ``layer6``."""

    def __init__(self, inc: int = 256, midc: int = 256, outc: int = 512,
                 drop_rate: float = 0.1, block_size: int = 4):
        super().__init__()
        for k, (ksize, dil) in enumerate([(1, 1), (1, 1), (3, 6), (3, 12),
                                          (3, 18)]):
            pad = dil if ksize == 3 else 0
            setattr(self, f"aspp_{k}", nn.Sequential(
                BatchNorm(inc), DropBlock(drop_rate, block_size),
                Conv(inc, midc, ksize, padding=pad, dilation=dil),
                nn.ReLU()))
        self.layer6 = Conv(5 * midc, outc, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        g = self.aspp_0(x.mean(dim=(2, 3), keepdim=True))
        g = g.expand(-1, -1, h, w)
        out = torch.cat([g, self.aspp_1(x), self.aspp_2(x), self.aspp_3(x),
                         self.aspp_4(x)], dim=1)
        return self.layer6(out)
