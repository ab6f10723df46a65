"""DropBlock2D (train-only structured dropout).

Counterpart of ``pemp_tpu/ops/dropblock.py`` (the semantics of the
``dropblock`` package the reference purifier uses):

- a Bernoulli seed mask with ``gamma = rate / block_size**2`` per sample
  over the spatial map, shared across channels;
- blocks grown by a stride-1 max-pool of kernel ``block_size`` and padding
  ``block_size // 2`` (one row and column cropped for even block sizes);
- the output rescaled by ``numel / kept`` over the whole [N, H, W] mask.

The uniforms come from an explicit ``torch.Generator`` on the tensor's
device; ``dropblock_mask`` takes them as an argument so a test can feed
the JAX package's construction and this one the same numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def dropblock_mask(uniform: torch.Tensor, rate: float, block_size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uniform [N, H, W] in [0, 1) -> (block mask [N, H, W] of 0/1 float32,
    the scalar rescale ``numel / max(kept, 1)``)."""
    seed = (uniform < rate / block_size ** 2).to(torch.float32)
    grown = F.max_pool2d(seed[:, None], block_size, stride=1,
                         padding=block_size // 2)[:, 0]
    if block_size % 2 == 0:
        grown = grown[:, :-1, :-1]
    mask = 1.0 - grown
    return mask, mask.numel() / torch.clamp(mask.sum(), min=1.0)


def dropblock_2d(x: torch.Tensor, rate: float, block_size: int,
                 generator: Optional[torch.Generator] = None,
                 shard=None) -> torch.Tensor:
    """DropBlock on NCHW ``x`` (train mode); the identity at rate 0.
    ``generator`` (on ``x``'s device) draws the [N, H, W] uniforms; None
    uses PyTorch's default generator of that device. With ``shard`` (a
    ``parallel.mesh.RowShard``), ``x`` is this process's rows of a global
    batch: the uniforms and the rescale are the global batch's, and the
    mask keeps this process's rows."""
    if rate == 0.0:
        return x
    n, _, h, w = x.shape
    world = 1 if shard is None else shard.world
    uniform = torch.rand((n * world, h, w), generator=generator,
                         device=x.device)
    mask, scale = dropblock_mask(uniform, rate, block_size)
    if shard is not None:
        mask = shard.local(mask)
    return (x * (mask * scale)[:, None]).to(x.dtype)
