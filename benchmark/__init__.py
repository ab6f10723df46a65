"""The benchmark of the PyTorch/CUDA port (``pemp_tpu_torch``): see
``run.py`` and ``PERF.md``."""
