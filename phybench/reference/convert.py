"""Carry the reference simulator's estimator state into the port.

The estimator matrices (and the estimators' error variances) are this
system's only state beyond the static plans: with them converted, the JAX
simulators and the port's run with identical estimators.
"""
from __future__ import annotations

import numpy as np
import torch


def wiener_stack_from_reference(packed, device):
    """packed: [n_ps, Np, n_sc, 2] float32 per-pilot-symbol Wiener matrices,
    re/im on the last axis (make_wiener_stack of either package). Returns
    the complex64 [n_ps, Np, n_sc] tensor estimate_channel takes."""
    w = np.asarray(packed, np.float32)
    if w.ndim != 4 or w.shape[-1] != 2:
        raise ValueError(f"wiener stack {w.shape} must be [n_ps, Np, n_sc, 2]")
    return from_packed(w, device)


def from_packed(packed, device):
    """float32 [..., 2] with re/im on the last axis -> complex64 [...] on
    `device`."""
    w = np.asarray(packed, np.float32)
    return torch.complex(torch.from_numpy(np.ascontiguousarray(w[..., 0])),
                         torch.from_numpy(np.ascontiguousarray(w[..., 1]))
                         ).to(device)
