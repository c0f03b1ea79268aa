"""QAM constellation mappings per 3GPP TS 36.211 §7.1.

The reference uses Q15 fixed-point amplitude tables
(openair1/PHY/LTE_REFSIG/mod_table.h:34); here constellations are unit-energy
float32 — the TPU pipeline is floating point throughout, with BLER (not
bit-exactness) as the fidelity contract.

Bit-to-symbol convention (36.211 §7.1): for Qm bits b0..b{Qm-1} per symbol,
b0 drives the sign of I, b1 the sign of Q, and the remaining bits select the
amplitude ring. Gray mapping as specified: bit 0 => positive axis level.
"""
from __future__ import annotations

import numpy as np

_SQRT2 = np.sqrt(2.0)
_SQRT10 = np.sqrt(10.0)
_SQRT42 = np.sqrt(42.0)


def qpsk_table() -> np.ndarray:
    """[4] complex64: index = b0*2 + b1 (b0 -> I sign, b1 -> Q sign)."""
    out = np.empty(4, np.complex64)
    for b0 in (0, 1):
        for b1 in (0, 1):
            i = (1 - 2 * b0) / _SQRT2
            q = (1 - 2 * b1) / _SQRT2
            out[b0 * 2 + b1] = i + 1j * q
    return out


def qam16_table() -> np.ndarray:
    """[16] complex64: index = b0*8 + b1*4 + b2*2 + b3.

    36.211 Table 7.1.3-1: amplitude = 1/sqrt(10) if the ring bit is 0 else
    3/sqrt(10); b2 selects |I|, b3 selects |Q|.
    """
    out = np.empty(16, np.complex64)
    for idx in range(16):
        b0, b1, b2, b3 = (idx >> 3) & 1, (idx >> 2) & 1, (idx >> 1) & 1, idx & 1
        ai = (1 if b2 == 0 else 3) / _SQRT10
        aq = (1 if b3 == 0 else 3) / _SQRT10
        out[idx] = (1 - 2 * b0) * ai + 1j * (1 - 2 * b1) * aq
    return out


def qam64_table() -> np.ndarray:
    """[64] complex64: index = b0*32 + b1*16 + b2*8 + b3*4 + b4*2 + b5.

    36.211 Table 7.1.4-1: |I| from (b2,b4) in {3,1,5,7}/sqrt(42),
    |Q| from (b3,b5) likewise.
    """
    amp = {(0, 0): 3, (0, 1): 1, (1, 0): 5, (1, 1): 7}
    out = np.empty(64, np.complex64)
    for idx in range(64):
        b = [(idx >> (5 - k)) & 1 for k in range(6)]
        ai = amp[(b[2], b[4])] / _SQRT42
        aq = amp[(b[3], b[5])] / _SQRT42
        out[idx] = (1 - 2 * b[0]) * ai + 1j * (1 - 2 * b[1]) * aq
    return out


def mod_table(Qm: int) -> np.ndarray:
    if Qm == 2:
        return qpsk_table()
    if Qm == 4:
        return qam16_table()
    if Qm == 6:
        return qam64_table()
    raise ValueError(f"unsupported Qm={Qm}")
