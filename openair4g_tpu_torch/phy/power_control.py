"""Uplink open-loop and closed-loop power control, 36.213 §5.1
(counterpart of openair4g_tpu/phy/power_control.py): host-side
arithmetic in dBm that sets the simulators' per-UE gains; on the device
the result is one amplitude multiplier.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def pusch_power_dbm(n_rb_alloc: int, p0_pusch: float, alpha: float,
                    pathloss_db: float, delta_tf: float = 0.0,
                    f_accum: float = 0.0, p_cmax: float = 23.0) -> float:
    """P_PUSCH = min(Pcmax, 10log10(M_RB) + P0 + alpha*PL + dTF + f)."""
    return min(p_cmax, 10.0 * np.log10(n_rb_alloc) + p0_pusch
               + alpha * pathloss_db + delta_tf + f_accum)


def delta_tf_db(sum_kr: int, n_re: int, ks: float = 1.25,
                delta_offset_db: float = 0.0) -> float:
    """dTF = 10log10((2^(Ks*BPRE) - 1)) with BPRE = sum Kr / N_RE
    (36.213 §5.1.1.1; 0 when Ks = 0)."""
    if ks == 0:
        return delta_offset_db
    bpre = sum_kr / max(n_re, 1)
    return 10.0 * np.log10(max(2.0 ** (ks * bpre) - 1.0, 1e-9)) \
        + delta_offset_db


def pucch_power_dbm(p0_pucch: float, pathloss_db: float,
                    delta_format: float = 0.0, h_n: float = 0.0,
                    g_accum: float = 0.0, p_cmax: float = 23.0) -> float:
    """P_PUCCH = min(Pcmax, P0 + PL + h(n_cqi, n_harq) + dF + g)."""
    return min(p_cmax, p0_pucch + pathloss_db + delta_format + h_n + g_accum)


def srs_power_dbm(n_rb_srs: int, p0_pusch: float, alpha: float,
                  pathloss_db: float, p_srs_offset_db: float = 0.0,
                  f_accum: float = 0.0, p_cmax: float = 23.0) -> float:
    return min(p_cmax, p_srs_offset_db + 10.0 * np.log10(n_rb_srs)
               + p0_pusch + alpha * pathloss_db + f_accum)


# TPC command -> accumulated dB step (36.213 Table 5.1.1.1-2)
TPC_ACCUM_DB = {0: -1.0, 1: 0.0, 2: 1.0, 3: 3.0}
TPC_ABS_DB = {0: -4.0, 1: -1.0, 2: 1.0, 3: 4.0}


@dataclass
class ClosedLoopState:
    """f(i) accumulation for PUSCH (g(i) for PUCCH is the same recursion)."""
    f_db: float = 0.0
    accumulate: bool = True

    def apply_tpc(self, cmd: int) -> float:
        if self.accumulate:
            self.f_db += TPC_ACCUM_DB[cmd]
        else:
            self.f_db = TPC_ABS_DB[cmd]
        return self.f_db


@dataclass
class PrachRamping:
    """PRACH power ramping (36.321 §5.1.3; reference UE PRACH procedure):
    target received power, +step per failed attempt, capped at Pcmax."""
    target_rx_dbm: float = -104.0
    step_db: float = 2.0
    p_cmax: float = 23.0
    n_attempts: int = field(default=0)

    def next_power_dbm(self, pathloss_db: float) -> float:
        p = self.target_rx_dbm + pathloss_db \
            + self.step_db * self.n_attempts
        self.n_attempts += 1
        return min(self.p_cmax, p)
