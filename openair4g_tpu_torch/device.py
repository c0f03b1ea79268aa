"""Device selection, float32 matmul precision, and kernel launch counters.

Importing this module turns TF32 off for matmuls and cuDNN: the port's
soft values are held to the JAX reference in full float32, and the CRC
GF(2) products must stay exact sums.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# One count per hand-written kernel: each wrapper adds one where it
# launches its kernel, and nowhere else.
_LAUNCHES = {"turbo_half_iter": 0, "turbo_half_iter_v1": 0, "mrc_llr": 0,
             "demap_llr": 0}


def default_device() -> torch.device:
    """`cuda` when a card is present, else `cpu` (the CPU serves the tests)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(_LAUNCHES)
