"""Shared helpers of the benchmark's tests: the repository root on the
path, small copies of the cells for the CPU, the card fixture."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def toy_cell(name: str, hw: int = 65, **mix):
    """The cell ``name`` at ``hw`` x ``hw`` with the program in float32,
    its mix overridden by ``mix``: a size a CPU test run holds."""
    from benchmark import manifest
    cell = manifest.cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["data"].update(height=hw, width=hw)
    cell.config["precision"]["encoder"] = "f32"
    cell.mix = {**cell.mix, **mix}
    return cell


TOY_MIXES = {
    "pemp-s1-r50.train-b4-fuse8": dict(batch=2, fuse_steps=2,
                                       pool_batches=4, warmup_calls=0,
                                       profile_calls=1),
    "pemp-s2-r50.eval-cascade-b1": dict(pool_batches=8, warmup_calls=1,
                                        profile_calls=2),
    "pemp-s1-r50.serve-b1": dict(pool_batches=4, warmup_calls=1,
                                 profile_calls=2),
}


@pytest.fixture
def card():
    """The first CUDA device; the test skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
