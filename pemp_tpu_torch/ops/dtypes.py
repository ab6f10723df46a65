"""Dtype helpers shared by ops and models."""

import torch


def f32up(x: torch.Tensor) -> torch.Tensor:
    """Cast to at least float32 without ever downcasting: bf16/f16 -> f32,
    f32 stays f32 and f64 stays f64 (counterpart of
    ``pemp_tpu.ops.dtypes.f32up``)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
