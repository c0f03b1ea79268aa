"""UL-SCH configuration, uplink channel estimation and SC-FDMA equalization
(counterpart of openair4g_tpu/phy/pusch.py).

The estimator is the delay-domain LMMSE projection of the LS estimate on
each DMRS symbol, one [M, M] complex matrix built on the host in float64
(a uniform delay prior over the CP), then time weights onto the data
symbols. The equalizer is the per-subcarrier MMSE filter with the exact
post-despread effective SINR: rho = mean_k g_k / (1 + g_k),
SINR_eff = rho / (1 - rho).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..device import device_plan
from ..tables.tbs import get_Qm_ul, get_TBS_UL
from .scfdma import PuschMap, dmrs_symbol_indices

_EPS = 1e-12


@dataclass(frozen=True)
class UlschConfig:
    """The fields phy/pdsch.DlschCodec reads (tbs, Qm, G, rv and the
    decoder's), for UL-SCH data: the 36.212 bit chain is the DL-SCH's."""
    mcs: int
    n_rb_alloc: int
    normal_cp: bool = True
    rv: int = 0
    n_turbo_iter: int = 8
    decoder_window: int | None = None   # None: 96 on CPU, 240 on CUDA
    decoder_warmup: int = 24
    g_override: int | None = None   # set when UCI takes REs (ops/uci.py)

    @property
    def tbs(self) -> int:
        return get_TBS_UL(self.mcs, self.n_rb_alloc)

    @property
    def Qm(self) -> int:
        return get_Qm_ul(self.mcs)

    @property
    def n_data_symbols(self) -> int:
        return (14 if self.normal_cp else 12) - 2   # less the 2 DMRS symbols

    @property
    def G(self) -> int:
        if self.g_override is not None:
            return self.g_override
        return self.n_data_symbols * 12 * self.n_rb_alloc * self.Qm


# ---------------------------------------------------------------------- CE --

@functools.lru_cache(maxsize=None)
def _ul_wiener_matrix(n_rb: int, n_rb_alloc: int, rb_offset: int,
                      n0: float, normal_cp: bool = True) -> np.ndarray:
    """[M, M] delay-domain LMMSE smoothing of the LS estimate, applied as
    ls @ W."""
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp)
    m_sc = 12 * n_rb_alloc
    f_idx = rb_offset * 12 + np.arange(m_sc) - 6 * n_rb
    L = fp.cp + 2
    taps = np.arange(L)
    F = np.exp(-2j * np.pi * f_idx[:, None] * taps[None, :] / fp.n_fft)
    P = 1.0 / L
    A = (F * P) @ F.conj().T + n0 * np.eye(m_sc)
    W = (F * P) @ F.conj().T @ np.linalg.inv(A)     # [M, M]
    return W.T.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _ul_time_weights(data_syms: tuple, normal_cp: bool = True,
                     hopped: bool = False) -> np.ndarray:
    """[n_data_sym, 2] linear weights between the two DMRS symbols,
    clamped outside them; with frequency hopping each slot uses only its
    own DMRS (step weights)."""
    fp = FrameParms(n_rb=6, normal_cp=normal_cp)   # symbol layout only
    d0, d1 = dmrs_symbol_indices(fp)
    half = fp.symbols_per_subframe // 2
    Wt = np.zeros((len(data_syms), 2), np.float32)
    for i, l in enumerate(data_syms):
        if hopped:
            Wt[i] = (1.0, 0.0) if l < half else (0.0, 1.0)
        else:
            t = np.clip((l - d0) / (d1 - d0), 0.0, 1.0)
            Wt[i] = (1.0 - t, t)
    return Wt


def make_ul_wiener(pm: PuschMap, n0: float, device) -> torch.Tensor:
    """The [M, M] complex64 smoothing matrix for one noise level on
    `device`; passed to the estimator so an SNR sweep reuses one plan."""
    return torch.as_tensor(_ul_wiener_matrix(
        pm.fp.n_rb, pm.n_rb_alloc, pm.rb_offset, float(n0),
        pm.fp.normal_cp), device=device)


def _conj(a: np.ndarray) -> np.ndarray:
    return np.conj(a).astype(np.complex64)


def ul_estimate_channel(dmrs_rx, dmrs_ref: np.ndarray, pm: PuschMap, wiener):
    """dmrs_rx [B, 2, M] -> H_hat [B, n_data_sym, M]: LS on each DMRS
    symbol (multiply by the conjugate reference), the LMMSE smoothing
    `wiener` (make_ul_wiener), the time weights onto the data symbols.
    `dmrs_ref` must outlive the caller's use (it is uploaded once)."""
    dev = dmrs_rx.device
    ls = dmrs_rx * device_plan(dmrs_ref, dev, _conj)
    h = ls @ wiener                                              # [B, 2, M]
    Wt = device_plan(_ul_time_weights(tuple(pm.data_syms.tolist()),
                                      pm.fp.normal_cp, pm.hopped), dev)
    return Wt[:, 0, None] * h[:, None, 0] + Wt[:, 1, None] * h[:, None, 1]


# --------------------------------------------------------------- equalizer --

def scfdma_mmse_equalize(y, H, n0):
    """Per-subcarrier MMSE for DFT-spread OFDM, with the exact
    post-despread effective noise. y, H [B, C, M] -> (xf [B, C, M], the
    MMSE-filtered, bias-corrected symbols for the unitary IDFT; n0_eff
    [B, C, 1])."""
    h2 = (H * torch.conj(H)).real
    g = h2 / n0                                       # per-SC SNR
    mmse = torch.conj(H) / (h2 + n0)                  # MMSE filter
    rho = torch.mean(g / (1.0 + g), dim=-1, keepdim=True)
    rho = torch.clamp(rho, min=_EPS)
    xf = y * mmse / rho
    n0_eff = (1.0 - rho) / rho                        # unit-energy symbols
    return xf, torch.clamp(n0_eff, min=_EPS)
