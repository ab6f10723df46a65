"""The port's hand-written CUDA kernels (``csrc/``), their wrappers
(``mpm``, ``minplus``) and their build (``build``).

Inside ``with use_kernels(False):`` (the config key ``dev.use_kernels``,
the JAX package's ``tpu.use_pallas``) tensors on the card take the
kernels' plain PyTorch versions, which a CPU tensor always takes; outside
any such block they take the kernels. A runtime's commands run inside
``use_kernels(cfg.dev.use_kernels)`` (``core/experiment.py``). It is asked
for, never a fallback: with it on, a wrapper launches its kernel for a
CUDA tensor or raises.
"""

from contextlib import contextmanager

_STATE = {"kernels": True}


@contextmanager
def use_kernels(on: bool):
    """Within the block, launch the kernels for CUDA tensors (True) or
    run their plain versions there (False); the choice before the block
    comes back after it."""
    before = _STATE["kernels"]
    _STATE["kernels"] = bool(on)
    try:
        yield
    finally:
        _STATE["kernels"] = before


def kernels_on(device) -> bool:
    """Whether a tensor on ``device`` goes to a kernel: CUDA tensors while
    the kernels are on."""
    return device.type == "cuda" and _STATE["kernels"]
