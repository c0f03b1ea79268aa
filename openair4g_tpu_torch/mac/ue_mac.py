"""UE MAC: BSR / PHR control elements + UL HARQ entity.

Reference parity: openair2/LAYER2/MAC/ue_procedures.c — BSR trigger and
encoding (short/long BSR CEs, ue_send_sdu/update_bsr :86+, the LCG byte
layouts eNB-side decode mirrors at eNB_scheduler_ulsch.c:151-179), PHR
(periodicPHR/prohibitPHR timers, POWER_HEADROOM_CMD :1202-1260), and the
synchronous UL HARQ entity (8 processes, pid = (tti+4) mod 8 at the eNB
grant timing, NDI-toggle-means-new-TB).

BSR_TABLE is 36.321 Table 6.1.3.1-1 (same 64 constants as the reference's
vars.h:50). PHR mapping is 36.133 §9.1.8.4: index = PH + 23, clamped to
[0,63].

A copy of openair4g_tpu/mac/ue_mac.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

BSR_TABLE = (
    0, 10, 12, 14, 17, 19, 22, 26, 31, 36, 42, 49, 57, 67, 78, 91,
    105, 125, 146, 171, 200, 234, 274, 321, 376, 440, 515, 603, 706, 826,
    967, 1132, 1326, 1552, 1817, 2127, 2490, 2915, 3413, 3995, 4677, 5467,
    6411, 7505, 8787, 10287, 12043, 14099, 16507, 19325, 22624, 26487,
    31009, 36304, 42502, 49759, 58255, 68201, 79846, 93479, 109439,
    128125, 150000, 300000)

# MAC CE LCIDs (36.321 Table 6.2.1-2)
LCID_SHORT_BSR = 0x1D
LCID_LONG_BSR = 0x1E
LCID_PHR = 0x1A


def bsr_index(nbytes: int) -> int:
    """Smallest index whose table value covers nbytes (the reference's
    while loop at eNB_scheduler_ulsch.c:401)."""
    i = 0
    while i < len(BSR_TABLE) - 1 and BSR_TABLE[i] < nbytes:
        i += 1
    return i


def pack_short_bsr(lcgid: int, nbytes: int) -> bytes:
    """1-byte short BSR CE: LCG ID (2 bits) + buffer-size index (6)."""
    return bytes([((lcgid & 3) << 6) | bsr_index(nbytes)])


def unpack_short_bsr(ce: bytes) -> tuple:
    """-> (lcgid, buffer_bytes upper bound)."""
    return ce[0] >> 6, BSR_TABLE[ce[0] & 0x3F]


def pack_long_bsr(nbytes4) -> bytes:
    """3-byte long BSR CE: four 6-bit indices (LCG 0..3), the byte layout
    the eNB decodes at eNB_scheduler_ulsch.c:166-171."""
    idx = [bsr_index(int(n)) for n in nbytes4]
    assert len(idx) == 4
    return bytes([(idx[0] << 2) | (idx[1] >> 4),
                  ((idx[1] & 0xF) << 4) | (idx[2] >> 2),
                  ((idx[2] & 0x3) << 6) | idx[3]])


def unpack_long_bsr(ce: bytes) -> tuple:
    i0 = (ce[0] & 0xFC) >> 2
    i1 = ((ce[0] & 0x3) << 4) | ((ce[1] & 0xF0) >> 4)
    i2 = ((ce[1] & 0xF) << 2) | ((ce[2] & 0xC0) >> 6)
    i3 = ce[2] & 0x3F
    return tuple(BSR_TABLE[i] for i in (i0, i1, i2, i3))


def pack_phr(ph_db: float) -> bytes:
    """1-byte PHR CE: PH index = round(PH) + 23 in [0, 63] (36.133)."""
    return bytes([int(np.clip(round(ph_db) + 23, 0, 63))])


def unpack_phr(ce: bytes) -> float:
    return float((ce[0] & 0x3F) - 23)


@dataclass
class UlHarqProcess:
    tb: bytes = b""
    ndi: int = 0
    round: int = 0
    active: bool = False


class UeUlHarqEntity:
    """Synchronous UL HARQ: 8 processes, rv cycle 0,2,3,1 (36.321
    §5.4.2.2), NDI toggle starts a new TB."""
    RV_SEQ = (0, 2, 3, 1)

    def __init__(self):
        self.procs = [UlHarqProcess() for _ in range(8)]

    def on_grant(self, pid: int, ndi: int, tb: bytes | None) -> dict:
        """Returns what to transmit: dict(tb, rv, new)."""
        p = self.procs[pid]
        if not p.active or ndi != p.ndi:
            p.tb = tb if tb is not None else b""
            p.ndi = ndi
            p.round = 0
            p.active = True
            return dict(tb=p.tb, rv=0, new=True)
        p.round += 1
        return dict(tb=p.tb, rv=self.RV_SEQ[p.round & 3], new=False)

    def on_ack(self, pid: int) -> None:
        self.procs[pid].active = False

    def round_of(self, pid: int) -> int:
        return self.procs[pid].round


@dataclass
class UeMac:
    """UE MAC scheduling info: UL buffers per LCG + BSR/PHR generation.

    `periodic_bsr_sf` / `periodic_phr_sf` / `prohibit_phr_sf` mirror the
    reference's periodicBSR/periodicPHR/prohibitPHR timers."""
    periodic_bsr_sf: int = 10
    periodic_phr_sf: int = 20
    prohibit_phr_sf: int = 20
    p_cmax_db: float = 23.0

    buffers: list = field(default_factory=lambda: [0, 0, 0, 0])
    _bsr_timer: int = 0
    _phr_timer: int = 0
    _phr_prohibit: int = 0
    harq: UeUlHarqEntity = field(default_factory=UeUlHarqEntity)

    def offer_data(self, lcg: int, nbytes: int) -> None:
        self.buffers[lcg] += nbytes

    def total_buffer(self) -> int:
        return sum(self.buffers)

    def tick(self) -> None:
        self._bsr_timer += 1
        self._phr_timer += 1
        if self._phr_prohibit > 0:
            self._phr_prohibit -= 1

    def pending_ces(self, pusch_power_db: float = 0.0) -> list:
        """MAC CEs to multiplex into the next UL grant: (lcid, ce_bytes).
        BSR when the periodic timer fired and there is data; PHR when the
        periodic timer fired and prohibit allows."""
        ces = []
        if self._bsr_timer >= self.periodic_bsr_sf and self.total_buffer():
            nz = [i for i, b in enumerate(self.buffers) if b]
            if len(nz) == 1:
                ces.append((LCID_SHORT_BSR,
                            pack_short_bsr(nz[0], self.buffers[nz[0]])))
            else:
                ces.append((LCID_LONG_BSR, pack_long_bsr(self.buffers)))
            self._bsr_timer = 0
        if self._phr_timer >= self.periodic_phr_sf and \
                self._phr_prohibit == 0:
            ces.append((LCID_PHR, pack_phr(self.p_cmax_db - pusch_power_db)))
            self._phr_timer = 0
            self._phr_prohibit = self.prohibit_phr_sf
        return ces

    def consume(self, nbytes: int) -> None:
        """Grant served nbytes: drain buffers LCG0-first (the priority
        order the reference serves at eNB_scheduler_ulsch.c:418-431)."""
        left = nbytes
        for i in range(4):
            take = min(left, self.buffers[i])
            self.buffers[i] -= take
            left -= take
