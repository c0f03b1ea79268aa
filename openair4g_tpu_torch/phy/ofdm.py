"""CP-OFDM modulation and demodulation, 36.211 §6.12 (counterpart of
openair4g_tpu/phy/ofdm.py): unitary FFTs batched over (batch, symbol),
with the per-symbol cyclic prefix added and removed by slicing."""
from __future__ import annotations

import numpy as np
import torch

from ..config import FrameParms


def _cp_lengths(fp: FrameParms) -> np.ndarray:
    return np.asarray([fp.cp0 if sym % fp.symbols_per_slot == 0 else fp.cp
                       for sym in range(fp.symbols_per_subframe)], np.int64)


def ofdm_modulate(grid, fp: FrameParms):
    """grid [B, nsym, n_fft] -> time samples [B, samples_per_tti]."""
    x = torch.fft.ifft(grid, dim=-1, norm="ortho")
    parts = []
    for sym, cp in enumerate(_cp_lengths(fp)):
        s = x[:, sym, :]
        parts.append(s[:, -int(cp):])
        parts.append(s)
    return torch.cat(parts, dim=-1)


def ofdm_modulate_host(grid: np.ndarray, fp: FrameParms) -> np.ndarray:
    """numpy form of ofdm_modulate, for waveforms a simulator builds once
    at construction: grid [..., nsym, n_fft] -> [..., samples_per_tti]
    (complex128 for a complex128 grid)."""
    x = np.fft.ifft(grid, axis=-1, norm="ortho")
    parts = []
    for sym, cp in enumerate(_cp_lengths(fp)):
        s = x[..., sym, :]
        parts.append(s[..., -int(cp):])
        parts.append(s)
    return np.concatenate(parts, axis=-1)


def ofdm_demodulate(t, fp: FrameParms):
    """time samples [B, samples_per_tti] -> grid [B, nsym, n_fft]."""
    offs = 0
    syms = []
    for cp in _cp_lengths(fp):
        start = offs + int(cp)
        syms.append(t[:, start:start + fp.n_fft])
        offs = start + fp.n_fft
    return torch.fft.fft(torch.stack(syms, dim=1), dim=-1, norm="ortho")
