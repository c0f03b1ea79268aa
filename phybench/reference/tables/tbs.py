"""MCS / TBS lookups per 3GPP TS 36.213 §7.1.7.

Behavioral parity with the reference's openair1/PHY/LTE_TRANSPORT/lte_mcs.c
(get_Qm :45, get_I_TBS :69, get_TBS_DL :117, get_G :336), re-expressed as plain
Python config-time helpers — these run on the host when a simulation config is
built; nothing here is in the device hot path.
"""
from __future__ import annotations

from ._tbs_data import TBS_TABLE


def get_Qm(mcs: int) -> int:
    """Downlink modulation order (bits/symbol) for MCS 0..28 (36.213 T7.1.7.1-1)."""
    if mcs < 10:
        return 2
    if mcs < 17:
        return 4
    return 6


def get_Qm_ul(mcs: int) -> int:
    """Uplink modulation order for MCS 0..28 (36.213 T8.6.1-1)."""
    if mcs < 11:
        return 2
    if mcs < 21:
        return 4
    return 6


def get_I_TBS(mcs: int) -> int:
    """Downlink MCS -> I_TBS row index (36.213 Table 7.1.7.1-1)."""
    if mcs < 10:
        return mcs
    if mcs == 10:
        return 9
    if mcs < 17:
        return mcs - 1
    if mcs == 17:
        return 15
    return mcs - 2


def get_I_TBS_ul(mcs: int) -> int:
    """Uplink MCS -> I_TBS row index (36.213 Table 8.6.1-1)."""
    if mcs <= 10:
        return mcs
    if mcs < 21:
        return mcs - 1
    return mcs - 2


def get_TBS_DL(mcs: int, nb_rb: int) -> int:
    """Transport block size in bits for a downlink (mcs, N_PRB) allocation."""
    if nb_rb < 1 or nb_rb > 110 or mcs >= 29:
        raise ValueError(f"invalid mcs={mcs} nb_rb={nb_rb}")
    return TBS_TABLE[get_I_TBS(mcs)][nb_rb - 1]


def get_TBS_UL(mcs: int, nb_rb: int) -> int:
    """Transport block size in bits for an uplink (mcs, N_PRB) allocation."""
    if nb_rb < 1 or nb_rb > 110 or mcs >= 29:
        raise ValueError(f"invalid mcs={mcs} nb_rb={nb_rb}")
    return TBS_TABLE[get_I_TBS_ul(mcs)][nb_rb - 1]


def get_G_dl(nb_rb: int, Qm: int, num_pdcch_symbols: int, *, Nl: int = 1,
             normal_cp: bool = True, siso: bool = True) -> int:
    """Number of PDSCH coded bits G for a full-band allocation in a plain
    downlink subframe (no PSS/SSS/PBCH REs in it — e.g. FDD subframe 7).

    Matches reference get_G (lte_mcs.c:336): with normal CP there are 14 OFDM
    symbols; `num_pdcch_symbols` carry control, 3 PDSCH symbols carry
    cell-specific RS. SISO leaves 10 data REs/RB on pilot symbols (only port-0
    pilots punctured), 2-port transmit diversity leaves 8.
    """
    pilot_res = 10 if siso else 8
    nsym_full = (11 if normal_cp else 9) - num_pdcch_symbols
    g = nb_rb * Qm * (nsym_full * 12 + 3 * pilot_res)
    return g * (Nl if not siso else 1)
