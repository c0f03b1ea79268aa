"""Gold sequences per 3GPP TS 36.211 §7.2 and scrambling (counterpart of
openair4g_tpu/ops/gold.py). The sequences are host-side numpy constants
per (c_init, length); on the device scrambling is an XOR on bits or a sign
flip on LLRs."""
from __future__ import annotations

import functools

import numpy as np


_NC = 1600


@functools.lru_cache(maxsize=None)
def gold_sequence(c_init: int, length: int) -> np.ndarray:
    """c(n) for n in [0, length): int8 {0,1}.

    x1(n+31) = x1(n+3) ^ x1(n);  x2(n+31) = x2(n+3)^x2(n+2)^x2(n+1)^x2(n)
    c(n) = x1(n+Nc) ^ x2(n+Nc), x1 init = 1, x2 init = c_init bits.
    """
    n_total = _NC + length + 31
    x1 = np.zeros(n_total, np.int8)
    x2 = np.zeros(n_total, np.int8)
    x1[0] = 1
    for i in range(31):
        x2[i] = (c_init >> i) & 1
    for n in range(n_total - 31):
        x1[n + 31] = x1[n + 3] ^ x1[n]
        x2[n + 31] = x2[n + 3] ^ x2[n + 2] ^ x2[n + 1] ^ x2[n]
    return (x1[_NC:_NC + length] ^ x2[_NC:_NC + length]).astype(np.int8)


def pdsch_cinit(rnti: int, q: int, ns: int, nid_cell: int) -> int:
    """36.211 §6.3.1: c_init = rnti·2^14 + q·2^13 + ⌊ns/2⌋·2^9 + N_ID_cell."""
    return (rnti << 14) + (q << 13) + ((ns >> 1) << 9) + nid_cell


def pusch_cinit(rnti: int, ns: int, nid_cell: int) -> int:
    """36.211 §5.3.1: c_init = rnti·2^14 + ⌊ns/2⌋·2^9 + N_ID_cell."""
    return (rnti << 14) + ((ns >> 1) << 9) + nid_cell


def _signs(seq: np.ndarray) -> np.ndarray:
    return 1.0 - 2.0 * seq.astype(np.float32)
