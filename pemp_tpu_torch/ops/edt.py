"""Exact Euclidean distance transform and the cedt boundary weight.

Counterpart of ``pemp_tpu/ops/edt.py`` with the min-plus phases of
``pemp_tpu/ops/pallas/minplus.py::edt2_pallas``. The squared EDT of a
boolean map is two min-plus products (``ops/kernels/minplus.py``):

1. along H: ``g2[b, i, w] = min_k (i - k)^2 + src2[b, k, w]``, with
   ``src2`` 0 on feature pixels and 1e12 elsewhere;
2. along W: ``edt2[b, i, j] = min_k g2[b, i, k] + (k - j)^2``.

On CUDA both phases run the CUDA kernel; on the CPU its plain version.
All values are integers below 2^24 (or the 1e12 sentinel), exact in
float32, so the result is bit-identical on either device and to the JAX
package's kernel. A map with no feature pixel gets ``sqrt(1e12) = 1e6``
everywhere, which makes its boundary weight exactly 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pemp_tpu_torch.ops.kernels.minplus import minplus

INF2 = 1.0e12       # > any real squared distance (edt2_pallas _INF2)


def offsets_sq(size: int, device) -> torch.Tensor:
    """(i - k)^2 for i, k < size, float32 [size, size] (symmetric)."""
    i = torch.arange(size, dtype=torch.float32, device=device)
    return (i[:, None] - i[None, :]) ** 2


def edt2(feature: torch.Tensor) -> torch.Tensor:
    """Squared exact EDT of a boolean [B, H, W] map: float32 [B, H, W],
    the squared distance from each pixel to the nearest True pixel."""
    b, h, w = feature.shape
    src2 = torch.where(feature, 0.0, INF2).to(torch.float32).contiguous()
    g2 = minplus(offsets_sq(h, feature.device), src2)          # [B, H, W]
    out = minplus(g2.reshape(b * h, w), offsets_sq(w, feature.device))
    return out.reshape(b, h, w)


def euclidean_distance_transform(feature: torch.Tensor,
                                 dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """Exact EDT of a boolean [B, H, W] map: distances in ``dtype``
    (1e6 where the map has no feature pixel). The squared distances are
    cast before the square root, so a float64 caller stays exact."""
    return torch.sqrt(edt2(feature).to(dtype))


def boundary_map(target: torch.Tensor) -> torch.Tensor:
    """Foreground boundary of integer labels [B, H, W] -> bool [B, H, W]:
    with ``m = (target == 1)`` and ``s`` its zero-padded 3x3 box sum,
    ``round((clamp(s, 0, 1) - m) + (m - clamp(s - 8, 0, 1))) >= 1``
    (reference core/losses.py:35-40). The box sum adds nine shifted
    views, so its small integers are exact on any device."""
    m = (target == 1).to(torch.float32)
    h, w = m.shape[-2:]
    p = F.pad(m, (1, 1, 1, 1))
    s = sum(p[:, i:i + h, j:j + w] for i in range(3) for j in range(3))
    dilated = torch.clamp(s, 0.0, 1.0) - m
    erosion = m - torch.clamp(s - 8.0, 0.0, 1.0)
    return torch.round(dilated + erosion) >= 1.0


def edt_boundary_weight(target: torch.Tensor, sigma: float,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-pixel CE weight ``exp(-EDT(boundary) / sigma^2) + 1``
    (reference core/losses.py:30); a function of the labels only."""
    edt = euclidean_distance_transform(boundary_map(target), dtype=dtype)
    return torch.exp(-edt / (sigma ** 2)) + 1.0
