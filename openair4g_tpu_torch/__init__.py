"""openair4g_tpu_torch — the PyTorch/CUDA port of openair4g_tpu.

Mirrors the JAX package's layout (`ops/`, `phy/`, `sim/`) with the same
module and function names. It imports torch and never jax; its two
hand-written Hopper kernels live in `csrc/` and are built by `kernels.py`.
"""
