"""The benchmark of the PyTorch / CUDA port ``mixdq_tpu_torch``: see
``run.py`` and ``BENCHMARK.json`` at the repository root."""
