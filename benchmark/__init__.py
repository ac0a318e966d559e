"""The benchmark of the PyTorch and CUDA port (``pyg_lib_tpu_torch``): see
``benchmark/README.md`` and ``BENCHMARK.json``."""
