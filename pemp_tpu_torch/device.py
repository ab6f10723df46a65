"""Device resolution: the port runs on the card unless the caller asks
for the CPU, and never falls back to the CPU on its own."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` or ``"cuda"`` -> the CUDA device (raises without CUDA);
    ``"cpu"`` -> the CPU, only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"Unsupported device '{device}' (cuda | cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (dev.device=cpu on "
            "the command line) to run on the CPU")
    return dev


def tool_precision(device: torch.device) -> str:
    """The compute precision of an operator tool on ``device``, taken from
    the platform as the JAX tools take theirs: bf16 on the card, f32 on
    the CPU."""
    return "bf16" if device.type == "cuda" else "f32"
