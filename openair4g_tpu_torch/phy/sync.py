"""PSS/SSS generation and cell search, 36.211 §6.11 (counterpart of
openair4g_tpu/phy/sync.py).

The PSS matched filter is one FFT-domain correlation of the whole 5 ms
capture against the three Nid2 replicas at once, batched over trials;
SSS detection correlates the PSS-equalized SSS REs with all 336 (Nid1,
half-frame) hypotheses of the detected Nid2 in one matmul. The sequences,
replica spectra and SSS hypothesis banks are host constants built once
and uploaded once per device.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import FrameParms
from ..device import device_plan

_PSS_ROOTS = (25, 29, 34)   # Nid2 0/1/2 (36.211 Table 6.11.1.1-1)


@functools.lru_cache(maxsize=None)
def pss_sequence(nid2: int) -> np.ndarray:
    """ZC62 PSS d_u(n), n=0..61 (36.211 §6.11.1.1)."""
    u = _PSS_ROOTS[nid2]
    n = np.arange(62)
    ph = np.where(n < 31, n * (n + 1), (n + 1) * (n + 2))
    return np.exp(-1j * np.pi * u * ph / 63.0).astype(np.complex64)


def _m_seq(taps) -> np.ndarray:
    """Length-31 m-sequence 1-2x with x(0..4)=(0,0,0,0,1), x(i+5)=sum taps."""
    x = np.zeros(31, np.int64)
    x[4] = 1
    for i in range(26):
        x[i + 5] = sum(x[i + t] for t in taps) % 2
    return (1 - 2 * x).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _sss_bases():
    s = _m_seq((2, 0))       # x(i+5) = x(i+2) + x(i)
    c = _m_seq((3, 0))       # x(i+5) = x(i+3) + x(i)
    z = _m_seq((4, 2, 1, 0))  # x(i+5) = x(i+4)+x(i+2)+x(i+1)+x(i)
    return s, c, z


def _m0_m1(nid1: int) -> tuple:
    qp = nid1 // 30
    q = (nid1 + qp * (qp + 1) // 2) // 30
    mp = nid1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    return m0, m1


@functools.lru_cache(maxsize=None)
def sss_sequence(nid1: int, nid2: int, second_half: bool) -> np.ndarray:
    """SSS d(0..61) for subframe 0 (False) / subframe 5 (True)."""
    s, c, z = _sss_bases()
    m0, m1 = _m0_m1(nid1)
    n = np.arange(31)
    c0 = c[(n + nid2) % 31]
    c1 = c[(n + nid2 + 3) % 31]
    if not second_half:
        even = s[(n + m0) % 31] * c0
        odd = s[(n + m1) % 31] * c1 * z[(n + (m0 % 8)) % 31]
    else:
        even = s[(n + m1) % 31] * c0
        odd = s[(n + m0) % 31] * c1 * z[(n + (m1 % 8)) % 31]
    d = np.empty(62, np.float64)
    d[0::2] = even
    d[1::2] = odd
    return d.astype(np.complex64)


def center62_grid_sc(fp: FrameParms) -> np.ndarray:
    """Occupied-grid subcarrier indices of the 62 sync REs (d(n) order)."""
    return (6 * fp.n_rb - 31 + np.arange(62)).astype(np.int32)


def center62_bins(fp: FrameParms) -> np.ndarray:
    return fp.sc_to_bin(center62_grid_sc(fp))


@functools.lru_cache(maxsize=None)
def pss_time_replica(nid2: int, n_fft: int) -> np.ndarray:
    """Unit-energy time-domain PSS symbol (no CP) at FFT size n_fft."""
    f = np.zeros(n_fft, np.complex128)
    d = pss_sequence(nid2)
    f[n_fft - 31 + np.arange(31)] = d[:31]
    f[np.arange(1, 32)] = d[31:]
    t = np.fft.ifft(f, norm="ortho")
    return (t / np.linalg.norm(t)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _replicas(n_fft: int) -> np.ndarray:
    """[3, n_fft] the three time-domain PSS replicas."""
    return np.stack([pss_time_replica(i, n_fft) for i in range(3)])


@functools.lru_cache(maxsize=None)
def _replica_spectra_conj(n_fft: int, fft_len: int) -> np.ndarray:
    """[3, fft_len] conj(FFT) of the zero-padded replicas."""
    pad = np.zeros((3, fft_len - n_fft), np.complex64)
    rep_f = np.fft.fft(np.concatenate([_replicas(n_fft), pad], axis=1),
                       axis=1).astype(np.complex64)
    return np.conj(rep_f)


@functools.lru_cache(maxsize=None)
def _pss_refs_conj() -> np.ndarray:
    return np.conj(np.stack([pss_sequence(i) for i in range(3)]))


@functools.lru_cache(maxsize=None)
def _sss_banks() -> np.ndarray:
    """[62, 3 * 336] float32: per Nid2 the 336 SSS hypotheses, half-frame
    major, then Nid1 (the sequences are real)."""
    cols = [sss_sequence(nid1, nid2, half).real
            for nid2 in range(3) for half in (False, True)
            for nid1 in range(168)]
    return np.stack(cols, axis=1).astype(np.float32)


class CellSearch:
    """PSS timing and Nid2 detection, then SSS Nid1 and half-frame
    detection, for one (FDD, CP) hypothesis; all trials batched."""

    def __init__(self, fp: FrameParms, capture_len: int | None = None):
        self.fp = fp
        # 5 ms half-frame capture plus one symbol of margin
        self.capture_len = capture_len or (5 * fp.samples_per_tti + fp.n_fft)
        # the reference's correlation length, a power of two; any length
        # of at least the capture gives the same linear correlation, this
        # one gives the reference's sums
        self._fft_len = 1 << (self.capture_len - 1).bit_length()
        self._bins = center62_bins(fp)

    def pss_correlate(self, r):
        """r [B, L] complex -> (peak_pos [B], nid2 [B], corr [B, 3, L],
        peak [B]): corr[t] = sum_n conj(p[n]) r[t+n] by FFT; the peak is the
        largest |corr|^2 over positions with a whole symbol after them, the
        first on a tie."""
        L, n_fft = self.capture_len, self.fp.n_fft
        rep = device_plan(_replica_spectra_conj(n_fft, self._fft_len),
                          r.device)
        rf = torch.fft.fft(r, n=self._fft_len, dim=-1)
        corr = torch.fft.ifft(rf[:, None, :] * rep, dim=-1)[..., :L]
        valid = L - n_fft
        flat = (corr[..., :valid].abs() ** 2).reshape(r.shape[0], -1)
        am = torch.argmax(flat, dim=-1)
        peak = flat.gather(1, am[:, None])[:, 0]
        return am % valid, am // valid, corr, peak

    def _extract62(self, r, start):
        """FFT the symbol starting at `start` (per trial; negative starts
        wrap to the capture's end, as the reference's gather does) and take
        the 62 sync REs."""
        L, n_fft = r.shape[-1], self.fp.n_fft
        idx = start[:, None] + torch.arange(n_fft, device=r.device)
        sym = r.gather(1, torch.remainder(idx, L))
        f = torch.fft.fft(sym, dim=-1, norm="ortho")
        return f[:, device_plan(self._bins, r.device, dtype=torch.long)]

    def sss_detect(self, r, pss_pos, nid2):
        """Coherent SSS detection -> (nid1 [B], half [B] in {0, 1}). The SSS
        sits one symbol before the PSS (FDD); the channel is the PSS LS
        estimate; the decision is the hypothesis of largest real
        correlation, the first on a tie."""
        fp = self.fp
        dev = r.device
        pss_rx = self._extract62(r, pss_pos)
        sss_rx = self._extract62(r, pss_pos - (fp.n_fft + fp.cp))
        ch = pss_rx * device_plan(_pss_refs_conj(), dev)[nid2]
        z = sss_rx * torch.conj(ch)
        scores = (z.real @ device_plan(_sss_banks(), dev)).reshape(
            -1, 3, 336)
        scores = scores.gather(1, nid2[:, None, None].expand(-1, 1, 336))
        best = torch.argmax(scores[:, 0], dim=-1)
        return best % 168, best // 168

    def search(self, r):
        """Full cell search on [B, L] captures -> dict(pss_pos, nid2, nid1,
        half, nid_cell, peak)."""
        pos, nid2, _, peak = self.pss_correlate(r)
        nid1, half = self.sss_detect(r, pos, nid2)
        return dict(pss_pos=pos, nid2=nid2, nid1=nid1, half=half,
                    nid_cell=3 * nid1 + nid2, peak=peak)


def estimate_cfo(r, pss_pos, nid2, n_fft: int):
    """Fractional CFO [B] in subcarrier spacings from the PSS symbol's two
    halves: their product after removing the replica turns by
    pi * f_off / f_scs."""
    idx = pss_pos[:, None] + torch.arange(n_fft, device=r.device)
    sym = r.gather(1, idx)
    y = sym * torch.conj(device_plan(_replicas(n_fft), r.device)[nid2])
    h = n_fft // 2
    c = torch.sum(torch.conj(y[:, :h]) * y[:, h:], dim=-1)
    return torch.angle(c) / math.pi
