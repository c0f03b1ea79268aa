"""MRC combining and per-RE equalization (counterpart of
openair4g_tpu/phy/equalize.py): x_hat = sum_a y_a conj(H_a) / sum_a |H_a|^2,
n0_eff = n0 / sum_a |H_a|^2."""
from __future__ import annotations

import torch

_EPS = 1e-12


def mrc_equalize(y, H, n0):
    """y, H: [..., n_rx] complex. Returns (x_hat [...], n0_eff [...])."""
    num = torch.sum(y * torch.conj(H), dim=-1)
    h2 = torch.clamp(torch.sum((H * torch.conj(H)).real, dim=-1), min=_EPS)
    return num / h2, n0 / h2
