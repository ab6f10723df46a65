"""PEMP on PyTorch and CUDA for NVIDIA Hopper (H100).

The PyTorch counterpart of ``pemp_tpu``: the same few-shot segmentation
models, data contract and evaluation protocol, with the TPU's Pallas
kernels rewritten as hand-written CUDA C++ for ``sm_90a``. Module names
mirror ``pemp_tpu`` so each counterpart is easy to find:

- ``pemp_tpu_torch.device``  -- device resolution (CUDA unless asked).
- ``pemp_tpu_torch.config``  -- dataclass config tree + ``test with k=v`` CLI.
- ``pemp_tpu_torch.ops``     -- resize and prototype ops (plain PyTorch)
  and ``ops.kernels`` (the CUDA kernels, their build and wrappers).
- ``pemp_tpu_torch.models``  -- dilated ResNet, purifier, PEMP stage 1.
- ``pemp_tpu_torch.core``    -- eval losses, metrics, the evaluator.
- ``pemp_tpu_torch.data``    -- episodic sampler, SYNTH dataset, loader.
- ``pemp_tpu_torch.utils``   -- JAX-to-torch weight conversion, timer.
- ``pemp_tpu_torch.entry``   -- command-line entries.

The package imports ``torch`` and ``numpy`` only, never JAX or
``pemp_tpu``.
"""

__version__ = "0.1.0"
