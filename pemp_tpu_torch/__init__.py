"""PEMP on PyTorch and CUDA for NVIDIA Hopper (H100).

The PyTorch counterpart of ``pemp_tpu``: the same few-shot segmentation
models, data contract, training and evaluation protocol, with the TPU's
Pallas kernels rewritten as hand-written CUDA C++ for ``sm_90a``. Module
names mirror ``pemp_tpu`` so each counterpart is easy to find:

- ``pemp_tpu_torch.device``  -- device resolution (CUDA unless asked).
- ``pemp_tpu_torch.config``  -- dataclass config tree, ``train``/``test
  with k=v`` CLI, run directories.
- ``pemp_tpu_torch.ops``     -- resize, prototype, DropBlock and EDT ops
  (plain PyTorch) and ``ops.kernels`` (the CUDA kernels, their build,
  wrappers and the mpm autograd Function).
- ``pemp_tpu_torch.models``  -- dilated ResNet and VGG16 backbones (and
  their communication-module variants), purifiers, PEMP stages 1 and 2,
  Baseline, PANet, the model registry.
- ``pemp_tpu_torch.core``    -- losses, metrics, solver, checkpoints,
  the trainer, the evaluator and the entries' shared runtime.
- ``pemp_tpu_torch.data``    -- episodic sampler, SYNTH dataset, loader.
- ``pemp_tpu_torch.utils``   -- JAX-to-torch weight conversion, timer.
- ``pemp_tpu_torch.entry``   -- command-line entries.

The package imports ``torch`` and ``numpy`` only, never JAX or
``pemp_tpu``.
"""

__version__ = "0.1.0"
