"""Weights drawn from the seed on the device, in a few large calls.

No pretrained file is in the repository, so both the program and the
reference load a state dict made from ``--seed``: one normal draw for
every convolution and linear weight (He scale, relu gain, fan-in), one
uniform draw for every bias (+-1/sqrt(fan_in), torch's) and for the
leaves a reference names in ``uniform``, batch norms at bias 0 and at the
weight the reference's ``norm_gain`` gives the module, running
statistics at 0 / 1. Float32, the type the parameters are held and
served in (the encoders compute under bf16 autocast). What a reference
does with the drawn state next (its calibration) is its own
(``benchmark/reference/<name>.py``, ``seeded_state``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

STATS = ("running_mean", "running_var", "num_batches_tracked")


def draw(layout: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
         device, norm_gain: Callable[[str], float] = lambda module: 1.0,
         uniform: Optional[Dict[str, Tuple[float, float]]] = None
         ) -> Dict[str, torch.Tensor]:
    """A state dict for ``layout`` ([(key, shape)], in state-dict order):
    ``norm_gain(module)`` is a norm's weight, ``uniform[leaf]`` the range
    of a leaf drawn uniformly."""
    uniform = uniform or {}
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = dict(layout)
    weights: List[Tuple[str, Tuple[int, ...]]] = []
    uniforms: List[Tuple[str, Tuple[int, ...], float, float]] = []
    out: Dict[str, torch.Tensor] = {}
    for key, shape in layout:
        module, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        if leaf in STATS:
            fill = 1.0 if leaf == "running_var" else 0.0
            dtype = torch.int64 if leaf == "num_batches_tracked" else None
            out[key] = torch.full(shape, fill, dtype=dtype, device=device)
        elif leaf in uniform:
            uniforms.append((key, shape, *uniform[leaf]))
        elif leaf == "weight" and len(shape) > 1:
            weights.append((key, shape))
        elif len(shapes.get(f"{module}.weight", ())) == 1:     # a norm
            gain = norm_gain(module)
            out[key] = torch.full(shape, gain if leaf == "weight" else 0.0,
                                  device=device)
        elif leaf == "bias":
            fan_in = math.prod(shapes[f"{module}.weight"][1:])
            bound = 1.0 / math.sqrt(fan_in)
            uniforms.append((key, shape, -bound, bound))
        else:
            raise ValueError(f"no rule draws {key} {shape}")
    if weights:
        flat = torch.randn(sum(math.prod(s) for _, s in weights),
                           generator=gen, device=device)
        at = 0
        for key, shape in weights:
            n = math.prod(shape)
            std = math.sqrt(2.0 / math.prod(shape[1:]))
            out[key] = (flat[at:at + n] * std).reshape(shape)
            at += n
    if uniforms:
        flat = torch.rand(sum(math.prod(s) for _, s, _, _ in uniforms),
                          generator=gen, device=device)
        at = 0
        for key, shape, lo, hi in uniforms:
            n = math.prod(shape)
            out[key] = (lo + (hi - lo) * flat[at:at + n]).reshape(shape)
            at += n
    return {key: out[key] for key, _ in layout}
