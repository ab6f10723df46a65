"""Checkpoint save/load.

Counterpart of ``pemp_tpu/core/checkpoint.py``: a checkpoint is
``torch.save`` of ``{"model": state_dict, "optimizer": state_dict,
"epoch": int, "extra": dict}``, where ``extra`` holds the trainer state a
resume needs (``best_iou``, ``best_epoch``, the ``lr_policy`` state). The
trainer writes ``ckpt.pt`` every ``tr.ckpt_epoch`` epochs and
``bestckpt.pt`` on the best online-eval mIoU. ``model_state`` also takes
a bare ``state_dict`` (the eval slice's ``.pt`` files). ``find_snapshot``
finds another run's checkpoint (stage 2's frozen stage 1).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import torch

CKPT = "ckpt.pt"
BEST = "bestckpt.pt"


def save(path: Path, model: torch.nn.Module,
         optimizer: Optional[torch.optim.Optimizer] = None, epoch: int = 0,
         extra: Optional[Dict[str, Any]] = None) -> Path:
    """Write the checkpoint atomically (a temporary file, then rename)."""
    payload = {"model": model.state_dict(),
               "optimizer": (optimizer.state_dict()
                             if optimizer is not None else {}),
               "epoch": int(epoch), "extra": extra or {}}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)
    return path


def load(path: Path) -> Dict[str, Any]:
    """The payload of a checkpoint (or a bare ``state_dict``), on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def model_state(payload: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` of a full checkpoint or a bare one."""
    if "model" in payload and isinstance(payload["model"], dict):
        return payload["model"]
    return payload


def find_snapshot(model_dir, tag: str, exp_id: int, ckpt: str = "") -> Path:
    """Another run's checkpoint (the JAX package's ``find_snapshot``, first
    two steps): ``ckpt`` as a path, else ``<model_dir>/<tag>/<exp_id>/``
    holding ``ckpt`` or, without one, ``bestckpt.pt`` then ``ckpt.pt``.
    Raises ``FileNotFoundError`` when there is none."""
    if ckpt and Path(ckpt).exists():
        return Path(ckpt)
    if exp_id >= 0:
        run_dir = Path(model_dir) / str(tag) / str(exp_id)
        for name in ([ckpt] if ckpt else [BEST, CKPT]):
            if (run_dir / name).exists():
                return run_dir / name
    raise FileNotFoundError(
        f"no checkpoint: ckpt={ckpt!r}, run {exp_id} of tag {tag!r} under "
        f"{model_dir}")
