"""Carry the reference simulator's estimator state into the port.

The joint-LMMSE matrix and its error variance are this system's only
state beyond the static plans: with them converted, the JAX DlsimFading
and the port's run with identical estimators.
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
    W = torch.complex(torch.from_numpy(np.ascontiguousarray(w[..., 0])),
                      torch.from_numpy(np.ascontiguousarray(w[..., 1])))
    return W.to(device), torch.from_numpy(ev.copy()).to(device)
