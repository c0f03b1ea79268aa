"""Uplink demodulation reference signals (Zadoff-Chu), 36.211 §5.5
(counterpart of openair4g_tpu/phy/ulref.py). Every sequence is a
configuration-time numpy constant (complex64); on the device the DMRS is
a static row written into the resource grid.
"""
from __future__ import annotations

import functools

import numpy as np

from ..tables._ul_dmrs_phi import PHI_12, PHI_24

# 36.211 Table 5.5.1.1: allowed M_sc^RS sizes (multiples of 12 with factors
# 2, 3, 5).
DFT_SIZES = (12, 24, 36, 48, 60, 72, 96, 108, 120, 144, 180, 192, 216, 240,
             288, 300, 324, 360, 384, 432, 480, 540, 576, 600, 648, 720, 864,
             900, 960, 972, 1080, 1152, 1200)


def _largest_prime_below(n: int) -> int:
    for p in range(n - 1, 1, -1):
        if all(p % d for d in range(2, int(p ** 0.5) + 1)):
            return p
    raise ValueError(n)


@functools.lru_cache(maxsize=None)
def zc_base_sequence(u: int, v: int, m_sc: int) -> np.ndarray:
    """Base sequence r_bar_{u,v}(n), n in [0, m_sc) (36.211 §5.5.1): u in
    [0, 30) the group, v in {0, 1} the sequence number (v = 1 only from
    6 RB)."""
    if m_sc not in DFT_SIZES:
        raise ValueError(f"M_sc={m_sc} is not a valid DMRS size")
    if m_sc >= 36:
        n_zc = _largest_prime_below(m_sc)
        qbar = n_zc * (u + 1) / 31.0
        q = int(np.floor(qbar + 0.5)) + v * (-1) ** int(np.floor(2 * qbar))
        m = np.arange(m_sc) % n_zc
        x = np.exp(-1j * np.pi * q * m * (m + 1) / n_zc)
        return x.astype(np.complex64)
    phi = PHI_12[u] if m_sc == 12 else PHI_24[u]
    return np.exp(1j * np.asarray(phi) * np.pi / 4).astype(np.complex64)


def pusch_dmrs(m_sc: int, u: int = 0, v: int = 0,
               cyclic_shift: int = 0) -> np.ndarray:
    """One DMRS sequence r(n) = e^{j alpha n} r_bar(n), alpha = 2 pi ncs / 12
    (36.211 §5.5.2.1.1); the same on both slots with group hopping off."""
    alpha = 2.0 * np.pi * cyclic_shift / 12.0
    n = np.arange(m_sc)
    return (np.exp(1j * alpha * n) * zc_base_sequence(u, v, m_sc)
            ).astype(np.complex64)
