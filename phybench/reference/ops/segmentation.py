"""Code block segmentation per 3GPP TS 36.212 §5.1.2.

Reference parity: openair1/PHY/CODING/lte_segmentation.c:39-160
(lte_segmentation). Pure host/config-time math: given a transport block size,
decide the number of code blocks C, their sizes K+/K-, and filler bits F.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..tables.qpp import QPP_TABLE

Z_MAX = 6144  # maximum code block size
_K_VALUES = tuple(k for k, _, _ in QPP_TABLE)


@dataclass(frozen=True)
class Segmentation:
    B: int        # input bits incl. transport-block CRC24A
    C: int        # number of code blocks
    Cplus: int    # blocks of size Kplus
    Cminus: int   # blocks of size Kminus
    Kplus: int
    Kminus: int
    F: int        # filler bits (prepended to first block)

    @property
    def block_sizes(self) -> tuple:
        return (self.Kminus,) * self.Cminus + (self.Kplus,) * self.Cplus


def segment_tb(B: int) -> Segmentation:
    """B = TBS + 24 (transport block CRC already counted)."""
    L = 0 if B <= Z_MAX else 24
    if B <= Z_MAX:
        C = 1
        Bp = B
    else:
        C = -(-B // (Z_MAX - L))  # ceil
        Bp = B + C * L
    # Kplus = smallest allowed K with C*K >= B'
    Kplus = next(k for k in _K_VALUES if C * k >= Bp)
    if C == 1:
        Kminus, Cminus, Cplus = 0, 0, 1
        F = Kplus - Bp
    else:
        Kminus = max(k for k in _K_VALUES if k < Kplus)
        dK = Kplus - Kminus
        Cminus = (C * Kplus - Bp) // dK
        Cplus = C - Cminus
        F = Cplus * Kplus + Cminus * Kminus - Bp
    return Segmentation(B=B, C=C, Cplus=Cplus, Cminus=Cminus,
                        Kplus=Kplus, Kminus=Kminus, F=F)
