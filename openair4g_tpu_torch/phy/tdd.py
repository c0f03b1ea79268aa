"""TDD frame structure type 2: UL/DL configurations and special subframes,
3GPP TS 36.211 §4.2 (Tables 4.2-1/4.2-2); counterpart of
openair4g_tpu/phy/tdd.py, a copy held equal to it by
tests/test_torch_meas_rf.py. The direction masks drive the per-TTI
procedure dispatch.
"""
from __future__ import annotations

import numpy as np

# Table 4.2-2: subframe pattern per UL/DL configuration.
# 'D' downlink, 'U' uplink, 'S' special.
TDD_PATTERNS = {
    0: "DSUUUDSUUU",
    1: "DSUUDDSUUD",
    2: "DSUDDDSUDD",
    3: "DSUUUDDDDD",
    4: "DSUUDDDDDD",
    5: "DSUDDDDDDD",
    6: "DSUUUDSUUD",
}

# Table 4.2-1 (normal CP): (DwPTS, GP, UpPTS) in OFDM symbols.
SPECIAL_SUBFRAME = {
    0: (3, 10, 1), 1: (9, 4, 1), 2: (10, 3, 1), 3: (11, 2, 1),
    4: (12, 1, 1), 5: (3, 9, 2), 6: (9, 3, 2), 7: (10, 2, 2), 8: (11, 1, 2),
}


def subframe_direction(tdd_config: int | None, subframe: int) -> str:
    """'D' / 'U' / 'S'; FDD (tdd_config None) is all-'D' on the DL carrier."""
    if tdd_config is None:
        return "D"
    return TDD_PATTERNS[tdd_config][subframe % 10]


def dl_subframes(tdd_config: int | None) -> tuple:
    if tdd_config is None:
        return tuple(range(10))
    return tuple(i for i, c in enumerate(TDD_PATTERNS[tdd_config])
                 if c == "D")


def ul_subframes(tdd_config: int | None) -> tuple:
    if tdd_config is None:
        return tuple(range(10))
    return tuple(i for i, c in enumerate(TDD_PATTERNS[tdd_config])
                 if c == "U")


def special_symbols(ssf_config: int, normal_cp: bool = True) -> dict:
    """Symbol budget of a special subframe: dict(dwpts, gp, uppts)."""
    dw, gp, up = SPECIAL_SUBFRAME[ssf_config]
    return dict(dwpts=dw, gp=gp, uppts=up)


def direction_mask(tdd_config: int | None) -> np.ndarray:
    """[10] int8: 0 = DL, 1 = UL, 2 = special — device-friendly mask."""
    m = np.zeros(10, np.int8)
    for i in range(10):
        c = subframe_direction(tdd_config, i)
        m[i] = 0 if c == "D" else (1 if c == "U" else 2)
    return m
