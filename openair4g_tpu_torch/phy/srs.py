"""Sounding reference signal: generation and the eNB's channel sounding,
36.211 §5.5.3 (counterpart of openair4g_tpu/phy/srs.py). The SRS is one
static frequency-domain row on a comb of 2 over the sounded band in the
last SC-FDMA symbol; sounding is a conjugate multiply and a delay-domain
IFFT (torch.fft.ifft).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..device import default_device, device_plan
from .ulref import DFT_SIZES, zc_base_sequence


@dataclass(frozen=True)
class SrsConfig:
    """One UE's SRS resource (a subset of 36.211 srs-ConfigDedicated)."""
    n_rb: int                 # system bandwidth
    srs_bw_rb: int = 20       # sounded bandwidth m_SRS in RBs (even)
    rb_offset: int = 0        # k0 start RB
    k_tc: int = 0             # transmission comb {0, 1}
    n_cs: int = 0             # cyclic shift {0..7}
    u: int = 0                # sequence group

    @property
    def m_sc(self) -> int:
        """Sequence length m_SRS * 12 / 2 (comb of 2)."""
        m = self.srs_bw_rb * 6
        if m not in DFT_SIZES:
            raise ValueError(f"SRS bandwidth {self.srs_bw_rb} RB -> "
                             f"M_sc={m} not a valid ZC size")
        return m


@functools.lru_cache(maxsize=None)
def srs_sequence(cfg: SrsConfig) -> np.ndarray:
    """r_SRS(n) = e^{j alpha n} r_bar_u(n), alpha = 2 pi n_cs / 8."""
    alpha = 2.0 * np.pi * cfg.n_cs / 8.0
    n = np.arange(cfg.m_sc)
    return (np.exp(1j * alpha * n) * zc_base_sequence(cfg.u, 0, cfg.m_sc)
            ).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def srs_bins(cfg: SrsConfig) -> np.ndarray:
    """FFT bins of the comb: k0 + 2n over the sounded band, centered."""
    fp = FrameParms(n_rb=cfg.n_rb)
    f0 = cfg.rb_offset * 12 - 6 * cfg.n_rb + cfg.k_tc
    f_idx = f0 + 2 * np.arange(cfg.m_sc, dtype=np.int64)
    return np.mod(f_idx, fp.n_fft).astype(np.int32)


def _conj(a: np.ndarray) -> np.ndarray:
    return np.conj(a)


def srs_fill_symbol(cfg: SrsConfig, batch: int, n_fft: int, device=None):
    """[B, n_fft] frequency-domain SRS symbol (the last SC-FDMA symbol) on
    `device` (None: the card)."""
    dev = default_device() if device is None else torch.device(device)
    row = torch.zeros(batch, n_fft, dtype=torch.complex64, device=dev)
    row[:, device_plan(srs_bins(cfg), dev, dtype=torch.long)] = \
        device_plan(srs_sequence(cfg), dev)
    return row


def srs_estimate(rx_symbol, cfg: SrsConfig):
    """The eNB's sounding from the received last-symbol DFT row [B, n_fft].

    Returns (H_hat [B, m_sc] LS channel over the comb, snr_db [B] wideband
    SNR estimate, t_off [B] timing offset in samples from the delay-domain
    peak)."""
    dev = rx_symbol.device
    ls = rx_symbol[:, device_plan(srs_bins(cfg), dev, dtype=torch.long)] \
        * device_plan(srs_sequence(cfg), dev, _conj)          # [B, M]
    # delay-domain view (a comb of 2: unambiguous delays up to n_fft / 2)
    g = torch.fft.ifft(ls, dim=-1)
    pk = torch.argmax(g.abs(), dim=-1)
    M = ls.shape[-1]
    fp = FrameParms(n_rb=cfg.n_rb)
    # comb spacing 2 subcarriers: delay resolution n_fft / (2 M) samples
    t_off = pk * fp.n_fft / (2 * M)
    t_off = torch.where(pk > M // 2, t_off - fp.n_fft / 2, t_off)
    # wideband SNR: the peak delay tap against the other taps' floor
    # (peak |g|^2 = |h|^2, noise taps have variance n0 / M)
    p = g.abs() ** 2
    psig = p.max(dim=-1).values
    pn = (p.sum(dim=-1) - psig) / (M - 1)
    snr_db = 10.0 * torch.log10(torch.clamp(
        psig / torch.clamp(pn * M, min=1e-12), min=1e-9))
    return ls, snr_db, t_off
