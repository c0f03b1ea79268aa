"""Multipath fading channels applied in the frequency domain (counterpart of
openair4g_tpu/sim/channels.py: the uncorrelated Rayleigh profiles, for any
number of TX and RX antennas).

Under the cyclic prefix a time-invariant multipath channel is a
per-subcarrier gain H(k) = sum_t a_t exp(-j 2 pi f_k tau_t): one matmul of
the taps with a static phase matrix, then one multiply on the grid.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms

# 36.101 Annex B.2 tap profiles: (delays us, powers dB).
PROFILES = {
    "EPA": ((0, .03, .07, .09, .11, .19, .41),
            (0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8)),
    "EVA": ((0, .03, .15, .31, .37, .71, 1.09, 1.73, 2.51),
            (0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9)),
    "ETU": ((0, .05, .12, .2, .23, .5, 1.6, 2.3, 5.0),
            (-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0)),
    "Rayleigh1": ((0.0,), (0.0,)),
}


@dataclass(frozen=True)
class ChannelModel:
    """Uncorrelated Rayleigh tap-delay-line channel, iid per (RX, TX)
    antenna pair."""
    name: str                 # key into PROFILES
    fp: FrameParms
    n_tx: int = 1
    n_rx: int = 1
    delay_scale: float = 1.0  # multiplies every tap delay

    def __post_init__(self):
        if self.name not in PROFILES:
            raise NotImplementedError(
                f"ChannelModel({self.name!r}): the port has the uncorrelated "
                f"Rayleigh profiles {sorted(PROFILES)}; Ricean LOS (Rice1, "
                "Rice8, SCM_D), antenna correlation (*_corr, *_anticorr, "
                "SCM_C, SCM_D), Rayleigh8 and AWGN are not ported")

    @property
    def n_taps(self) -> int:
        return len(PROFILES[self.name][0])

    @functools.cached_property
    def amps(self) -> np.ndarray:
        """Per-tap linear powers, normalized to sum 1."""
        a = 10.0 ** (0.1 * np.asarray(PROFILES[self.name][1], np.float64))
        return (a / a.sum()).astype(np.float32)

    @functools.cached_property
    def phase_matrix(self) -> np.ndarray:
        """[T, n_sc] complex64: exp(-j 2 pi f_k tau_t) at occupied SCs."""
        fp = self.fp
        k = np.arange(fp.n_sc)
        half = 6 * fp.n_rb
        f_idx = np.where(k < half, k - half, k - half + 1)   # DC skipped
        f_hz = f_idx.astype(np.float64) * 15000.0
        tau = np.asarray(PROFILES[self.name][0])[:, None] * 1e-6 \
            * self.delay_scale
        return np.exp(-2j * np.pi * f_hz[None, :] * tau).astype(np.complex64)

    def draw_taps(self, batch: int, normals=None, generator=None,
                  device=None):
        """Tap draw with E sum_t |a_t|^2 = 1 per antenna pair: iid complex
        Gaussian scaled by sqrt(amps/2). Returns [B, T] complex64 for a 1x1
        model and [B, n_rx, n_tx, T] otherwise. `normals`
        [B, n_rx, n_tx, T, 2] are injected standard normals; without them
        they are drawn from `generator` on `device`."""
        shape = (batch, self.n_rx, self.n_tx, self.n_taps, 2)
        if normals is None:
            normals = torch.randn(*shape, generator=generator, device=device)
        if normals.shape != shape:
            raise ValueError(f"normals {tuple(normals.shape)} != {shape}")
        scale = torch.sqrt(torch.as_tensor(self.amps, device=normals.device)
                           / 2.0)
        n = normals.to(torch.float32)
        a = torch.complex(scale * n[..., 0], scale * n[..., 1])
        return a[:, 0, 0] if self.n_tx == self.n_rx == 1 else a

    def freq_response(self, taps):
        """taps [..., T] -> H [..., n_sc] at the occupied subcarriers."""
        return taps @ torch.as_tensor(self.phase_matrix, device=taps.device)


def apply_channel_bins(grid, H, bins: np.ndarray, n_fft: int):
    """grid [B, nsym, n_fft] x H [B, len(bins)] at explicit FFT bins."""
    mult = torch.zeros(H.shape[0], n_fft, dtype=H.dtype, device=H.device)
    mult[:, torch.as_tensor(bins, dtype=torch.long, device=H.device)] = H
    return grid * mult[:, None, :]


def apply_channel_grid(grid, H, fp: FrameParms):
    """grid [B, nsym, n_fft] x H [B, n_sc] -> faded grid (exact under CP)."""
    return apply_channel_bins(grid, H, fp.sc_to_bin(np.arange(fp.n_sc)),
                              fp.n_fft)
