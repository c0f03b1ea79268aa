"""Random access procedure: RA-RNTI, RAR payload, contention resolution.

Reference parity: openair2/LAYER2/MAC/eNB_scheduler_RA.c (RAR scheduling),
openair1/PHY/LTE_TRANSPORT/rar_tools.c (RAR PDU pack/unpack: timing
advance, UL grant, T-CRNTI) and the UE side ra_procedures.c (preamble
selection, RAR window, Msg3).

The PRACH detection feeding this lives in phy/prach.py; the RAR rides a
normal DL-SCH transport block.

A copy of openair4g_tpu/mac/ra.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def ra_rnti(t_id: int, f_id: int = 0) -> int:
    """RA-RNTI = 1 + t_id + 10*f_id (36.321 §5.1.4)."""
    return 1 + (t_id % 10) + 10 * f_id


@dataclass(frozen=True)
class Rar:
    """One MAC RAR (36.321 §6.1.5 / 6.2.3): 6 bytes + subheader."""
    rapid: int              # detected preamble index (0..63)
    timing_advance: int     # 11 bits, in 16*Ts units
    ul_grant: int           # 20 bits (hopping|rb alloc|mcs|tpc|cqi req...)
    t_crnti: int            # 16 bits


def pack_rar(rar: Rar) -> np.ndarray:
    """-> [7] uint8: E/T/RAPID subheader + 6-byte RAR payload."""
    assert 0 <= rar.rapid < 64 and 0 <= rar.timing_advance < (1 << 11)
    assert 0 <= rar.ul_grant < (1 << 20) and 0 <= rar.t_crnti < (1 << 16)
    out = np.zeros(7, np.uint8)
    out[0] = 0x40 | rar.rapid                   # E=0, T=1, RAPID
    out[1] = (rar.timing_advance >> 4) & 0x7F   # R=0 + TA[10:4]
    out[2] = ((rar.timing_advance & 0xF) << 4) | ((rar.ul_grant >> 16) & 0xF)
    out[3] = (rar.ul_grant >> 8) & 0xFF
    out[4] = rar.ul_grant & 0xFF
    out[5] = (rar.t_crnti >> 8) & 0xFF
    out[6] = rar.t_crnti & 0xFF
    return out


def unpack_rar(pdu: np.ndarray) -> Rar:
    b = np.asarray(pdu, np.int64)
    assert b[0] & 0x40, "not a RAR subheader"
    return Rar(rapid=int(b[0] & 0x3F),
               timing_advance=int(((b[1] & 0x7F) << 4) | (b[2] >> 4)),
               ul_grant=int(((b[2] & 0xF) << 16) | (b[3] << 8) | b[4]),
               t_crnti=int((b[5] << 8) | b[6]))


def timing_advance_from_delay(delay_samples: float, n_fft: int) -> int:
    """PRACH-measured delay -> TA command (11-bit, 16*Ts granularity;
    Ts = 1/(15000*2048) regardless of the deployed FFT size)."""
    ts_scale = 2048 / n_fft              # samples at fs -> Ts units
    ta = int(round(delay_samples * ts_scale / 16.0))
    return int(np.clip(ta, 0, (1 << 11) - 1))


@dataclass
class RaProcedure:
    """UE-side RA state machine (ra_procedures.c): preamble -> RAR window
    -> Msg3 -> contention resolution, with power ramping on failure."""
    preamble: int
    max_attempts: int = 10
    attempts: int = 0
    state: str = "idle"        # idle -> preamble_sent -> rar_ok -> connected
    t_crnti: int | None = None
    contention_free: bool = False   # dedicated preamble (handover /
    #   PDCCH order, 36.321 §5.1.1): RAR completes the procedure — no
    #   Msg3 contention resolution

    def send_preamble(self) -> int:
        self.attempts += 1
        self.state = "preamble_sent"
        return self.preamble

    def on_rar(self, rar: Rar) -> bool:
        """True if this RAR addresses us (RAPID match) -> proceed to Msg3."""
        if self.state != "preamble_sent" or rar.rapid != self.preamble:
            return False
        self.t_crnti = rar.t_crnti
        self.state = "connected" if self.contention_free else "rar_ok"
        return True

    def on_rar_window_expiry(self) -> str:
        """-> 'retry' (ramped) or 'failed'."""
        if self.state == "rar_ok":
            return "ok"
        self.state = "idle"
        return "retry" if self.attempts < self.max_attempts else "failed"

    def on_contention_resolution(self, won: bool) -> None:
        self.state = "connected" if won else "idle"
