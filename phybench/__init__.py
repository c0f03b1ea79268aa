"""The benchmark of openair4g_tpu_torch, the PyTorch and CUDA port, on one
NVIDIA H100: configurations, traffic mixes, per-layer metrics and limits
as data files, found by the names in BENCHMARK.json. See README.md."""
