"""Carry the reference simulator's estimator state into the port.

The estimator matrices (and the joint estimator's error variance) are this
system's only state beyond the static plans: with them converted, the JAX
simulators and the port's run with identical estimators.
"""
from __future__ import annotations

import numpy as np
import torch


def estimator_state_from_reference(wiener, err_var, device):
    """wiener: [Np_total, n_sc, 2] float32 (re/im packed, as the reference's
    DlsimFading.wiener returns it); err_var: [n_data] float32 (its
    .err_var). Returns (W complex64 [Np_total, n_sc], ev float32 [n_data])
    on `device`."""
    w = np.asarray(wiener, np.float32)
    ev = np.asarray(err_var, np.float32)
    if w.ndim != 3 or w.shape[-1] != 2 or ev.ndim != 1:
        raise ValueError(f"wiener {w.shape} must be [Np, n_sc, 2] and "
                         f"err_var {ev.shape} [n_data]")
    return _complex(w).to(device), torch.from_numpy(ev.copy()).to(device)


def wiener_stack_from_reference(packed, device):
    """packed: [n_ps, Np, n_sc, 2] float32 per-pilot-symbol Wiener matrices,
    re/im on the last axis (make_wiener_stack of either package). Returns
    the complex64 [n_ps, Np, n_sc] tensor estimate_channel takes."""
    w = np.asarray(packed, np.float32)
    if w.ndim != 4 or w.shape[-1] != 2:
        raise ValueError(f"wiener stack {w.shape} must be [n_ps, Np, n_sc, 2]")
    return _complex(w).to(device)


def _complex(w: np.ndarray):
    return torch.complex(torch.from_numpy(np.ascontiguousarray(w[..., 0])),
                         torch.from_numpy(np.ascontiguousarray(w[..., 1])))
