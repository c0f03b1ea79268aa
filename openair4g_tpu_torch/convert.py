"""Carry the reference simulator's estimator state into the port.

The estimator matrices (and the estimators' error variances) are this
system's only state beyond the static plans: with them converted, the JAX
simulators and the port's run with identical estimators.
"""
from __future__ import annotations

import numpy as np
import torch


def estimator_state_from_reference(wiener, err_var, device):
    """The reference DlsimFading's `wiener(snr)` and `err_var(snr)` -> the
    port's, on `device`. wiener, re/im packed float32 on the last axis: the
    joint matrix [Np_total, n_sc, 2] (est_mode "joint"), the per-pilot-
    symbol stack [n_ps, Np, n_sc, 2] ("interp"), or the pair (joint
    matrix, DD smoother [n_sc, n_sc, 2]) ("dd"); err_var [n_data]. Returns
    (W as the port's DlsimFading.wiener gives it, complex64; ev float32)."""
    ev = np.asarray(err_var, np.float32)
    if ev.ndim != 1:
        raise ValueError(f"err_var {ev.shape} must be [n_data]")
    if isinstance(wiener, tuple):
        wj, wd = (np.asarray(w, np.float32) for w in wiener)
        if wj.ndim != 3 or wd.ndim != 3 or wj.shape[-1] != 2 \
                or wd.shape[-1] != 2 or wd.shape[0] != wd.shape[1]:
            raise ValueError(f"dd state {wj.shape}, {wd.shape} must be "
                             "[Np, n_sc, 2] and [n_sc, n_sc, 2]")
        W = (from_packed(wj, device), from_packed(wd, device))
    else:
        w = np.asarray(wiener, np.float32)
        if w.ndim not in (3, 4) or w.shape[-1] != 2:
            raise ValueError(f"wiener {w.shape} must be [Np, n_sc, 2] or "
                             "[n_ps, Np, n_sc, 2]")
        W = from_packed(w, device)
    return W, torch.from_numpy(ev.copy()).to(device)


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
