"""The one traffic generator: episodes from the seed, on the device.

A traffic mix is a JSON file ``benchmark/traffic/<mix>.json`` of
parameters that this module and the drivers read:

- ``mode``: ``train`` (fused train launches) or ``eval`` (the
  evaluator's step), both a closed loop of one client;
- ``batch``: episodes a step or a call; ``fuse_steps``: train steps a
  launch; ``pool_batches``: distinct batches made in set-up and cycled;
- ``gt``: ``input`` (query GT at the input's size) or ``own`` (each
  episode's GT at a size of its own, the PASCAL test protocol);
- ``check``: what the correctness check compares (``launches`` for
  train, ``episodes`` for eval); ``profile_calls``: the traced
  sub-window's length in calls.

The episodes follow the program's SYNTH generator
(``pemp_tpu_torch/data/synthetic.py``, copied here and run on the card):
an image U[0, 1) per channel, one elliptic blob (centre in the middle
half, radii between an eighth and a third of the side) that adds 0.5 to
the image and is the mask. With ``gt: own`` the episode's query GT is the
same blob rendered at (H + 1 + i, W + 1 + j), i < 17, j < 23, as SYNTH's
``data.var_gt`` sizes go; every seed gets the same list of sizes, in an
order of its own, so that seeds differ in values and not in work.
Images travel in the program's wire format (float16 images, uint8
masks), as its prefetcher stages them; a ``gt: own`` GT is a host array,
as the loader gives it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GT_EXTRA = (17, 23)     # SYNTH's var_gt: H + 1 + crc % 17, W + 1 + crc % 23
CHUNK = 8                   # episodes rendered at once


def load(name: str) -> Dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each stream (weights, data, dropout)."""
    return (int(seed) * 1_000_003 + stream) % (1 << 63)


def _blobs(n: int, h: int, w: int, gen: torch.Generator, device):
    """n ellipses: (cy, cx, ry, rx) as fractions of the side."""
    u = torch.rand((n, 4), generator=gen, device=device, dtype=torch.float64)
    cy = 0.25 + 0.5 * u[:, 0]
    cx = 0.25 + 0.5 * u[:, 1]
    ry = 1 / 8 + (1 / 3 - 1 / 8) * u[:, 2]
    rx = 1 / 8 + (1 / 3 - 1 / 8) * u[:, 3]
    return cy, cx, ry, rx


def _render(cy, cx, ry, rx, h: int, w: int) -> torch.Tensor:
    """Boolean [n, h, w] masks of the ellipses at size h x w."""
    dev = cy.device
    yy = torch.arange(h, device=dev, dtype=torch.float64)[None, :, None]
    xx = torch.arange(w, device=dev, dtype=torch.float64)[None, None, :]
    dy = (yy - (cy * h)[:, None, None]) / (ry * h)[:, None, None]
    dx = (xx - (cx * w)[:, None, None]) / (rx * w)[:, None, None]
    return dy * dy + dx * dx <= 1.0


def gt_sizes(n: int, h: int, w: int, seed: int) -> List[tuple]:
    """The same n sizes for every seed, in the seed's order."""
    sizes = [(h + 1 + i % GT_EXTRA[0], w + 1 + (7 * i) % GT_EXTRA[1])
             for i in range(n)]
    order = np.random.default_rng(sub_seed(seed, 4)).permutation(n)
    return [sizes[i] for i in order]


def episodes(cfg: Dict, mix: Dict, seed: int, device, stream: int = 1
             ) -> Dict:
    """``mix['pool_batches'] * mix['batch']`` episodes of the
    configuration's shot, query and size, made from ``seed``: device
    tensors ``sup_rgb`` [N,S,H,W,3], ``sup_mask`` [N,S,H,W,2] (fg, bg),
    ``qry_rgb`` [N,Q,H,W,3] and ``qry_msk`` ([N,Q,H,W] on the device, or
    with ``gt: own`` a list of N host arrays [Q,H',W']), ``cls`` [N];
    ``stream`` picks another draw from the same seed."""
    d = cfg["data"]
    s, q, h, w = d["shot"], d["query"], d["height"], d["width"]
    n = mix["pool_batches"] * mix["batch"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
    blob = _blobs(n * (s + q), h, w, gen, device)
    imgs = torch.empty((n, s + q, h, w, 3), dtype=torch.float16,
                       device=device)
    masks = torch.empty((n, s + q, h, w), dtype=torch.uint8, device=device)
    for lo in range(0, n, CHUNK):       # a few episodes a draw
        hi = min(lo + CHUNK, n)
        m = _render(*(t.reshape(n, s + q)[lo:hi].reshape(-1)
                      for t in blob), h, w).reshape(hi - lo, s + q, h, w)
        x = torch.rand((hi - lo, s + q, h, w, 3), generator=gen,
                       device=device)
        imgs[lo:hi] = x + 0.5 * m[..., None]
        masks[lo:hi] = m
    sup_fg = masks[:, :s]
    out = {
        "sup_rgb": imgs[:, :s].contiguous(),
        "sup_mask": torch.stack([sup_fg, 1 - sup_fg], -1),
        "qry_rgb": imgs[:, s:].contiguous(),
        "cls": np.random.default_rng(sub_seed(seed, 2)).integers(
            1, 21, n).astype(np.int32),
    }
    del imgs
    if mix["gt"] == "input":
        out["qry_msk"] = masks[:, s:].contiguous()
    elif mix["gt"] == "own":
        cy, cx, ry, rx = (t.reshape(n, s + q)[:, s:] for t in blob)
        out["qry_msk"] = [
            _render(cy[i], cx[i], ry[i], rx[i], gh, gw).to(torch.int32)
            .cpu().numpy() for i, (gh, gw) in
            enumerate(gt_sizes(n, h, w, seed))]
    else:
        raise ValueError(f"gt {mix['gt']!r} (input | own)")
    return out


def batch(pool: Dict, index: int, size: int) -> Dict:
    """Batch ``index`` (cycled) of ``size`` episodes of the pool."""
    n = len(pool["cls"])
    lo = (index * size) % n
    return {k: v[lo:lo + size] for k, v in pool.items()}
