"""LTE frame parameter derivation (3GPP TS 36.211 §6.12 / Table 6.13-1).

Reference parity: openair1/PHY/INIT/lte_parms.c:31 (init_frame_parms) — FFT
size, cyclic prefix lengths, and per-TTI sample counts derived from N_RB_DL.
"""
from __future__ import annotations

from dataclasses import dataclass

_NFFT_BY_NRB = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}


@dataclass(frozen=True)
class FrameParms:
    n_rb: int                  # N_RB_DL (6..100)
    normal_cp: bool = True
    n_id_cell: int = 0

    @property
    def n_fft(self) -> int:
        return _NFFT_BY_NRB[self.n_rb]

    @property
    def n_sc(self) -> int:
        return 12 * self.n_rb

    @property
    def symbols_per_slot(self) -> int:
        return 7 if self.normal_cp else 6

    @property
    def symbols_per_subframe(self) -> int:
        return 2 * self.symbols_per_slot

    @property
    def cp0(self) -> int:
        """CP of symbol 0 in each slot (samples), scaled from 160@2048."""
        if not self.normal_cp:
            return 512 * self.n_fft // 2048
        return 160 * self.n_fft // 2048

    @property
    def cp(self) -> int:
        """CP of symbols 1..6 (samples), scaled from 144@2048."""
        if not self.normal_cp:
            return 512 * self.n_fft // 2048
        return 144 * self.n_fft // 2048

    @property
    def samples_per_slot(self) -> int:
        n = self.symbols_per_slot
        return n * self.n_fft + self.cp0 + (n - 1) * self.cp

    @property
    def samples_per_tti(self) -> int:
        return 2 * self.samples_per_slot

    @property
    def sample_rate_hz(self) -> float:
        return 15000.0 * self.n_fft

    @property
    def nushift(self) -> int:
        return self.n_id_cell % 6

    def sc_to_bin(self, k):
        """Occupied subcarrier index k in [0, 12*n_rb) -> FFT bin.

        Negative-frequency half first (matches the reference's
        first_carrier_offset layout); DC bin is skipped.
        """
        import numpy as np
        k = np.asarray(k)
        half = 6 * self.n_rb
        neg = self.n_fft - half + k          # k < half
        pos = k - half + 1                   # k >= half (skip DC at bin 0)
        return np.where(k < half, neg, pos).astype(np.int32)
