"""eNB multi-UE uplink scheduler (schedule_ulsch pass).

Reference parity: openair2/LAYER2/MAC/eNB_scheduler_ulsch.c —
schedule_ulsch :599 (nCCE budget, first_rb=1 PUCCH guard, Msg3 skip) and
schedule_ulsch_rnti :659+ (per-UE pass: retransmissions keep their
allocation with rv cycling; new TBs sized by walking rb_table until the
TBS covers the BSR-reported buffer :401-431,:821-830; TPC from the
normalized RX power vs target :772-790; each grant consumes a format-0
DCI = 2^L CCEs from the common budget).

A copy of openair4g_tpu/mac/ul_scheduler.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..tables.tbs import get_TBS_UL
from .ue_mac import BSR_TABLE

# 36.213 step-allowed PUSCH sizes (2^a 3^b 5^c) — reference vars.h:70
RB_TABLE = (1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 15, 16, 18, 20, 24, 25, 27,
            30, 32, 36, 40, 45, 48, 50, 54, 60, 72, 75, 80, 81, 90, 96, 100)


@dataclass
class UlUeState:
    """Per-UE state the eNB tracks for UL scheduling."""
    rnti: int
    buffer_bytes: int = 0         # from the last decoded BSR
    mcs: int = 10
    retx_round: int = 0           # >0: HARQ retransmission pending
    retx_first_rb: int = 0
    retx_n_prb: int = 0
    rx_power_db: float = -90.0    # normalized PUSCH RX power estimate
    tpc_accum: int = 0
    sr_pending: bool = False


@dataclass
class UlGrant:
    rnti: int
    first_rb: int
    n_prb: int
    mcs: int
    rv: int
    tpc: int                      # 0:-1dB 1:0dB 2:+1dB 3:+3dB (36.213)
    ndi: int
    cce_offset: int
    L: int


RV_SEQ = (0, 2, 3, 1)


class UlScheduler:
    """One cell's schedule_ulsch pass. Call schedule() once per TTI."""

    def __init__(self, n_rb_ul: int, n_cce_max: int,
                 target_rx_power_db: float = -90.0, dci_L: int = 1):
        self.n_rb_ul = n_rb_ul
        self.n_cce_max = n_cce_max
        self.target = target_rx_power_db
        self.dci_L = dci_L           # log2 aggregation (reference uses 2^1)
        self.ndi: dict[int, int] = {}

    def _tpc(self, ue: UlUeState) -> int:
        """dci_tools TPC rule: pull the normalized RX power toward the
        target by +-1 dB per TTI (eNB_scheduler_ulsch.c:772-790)."""
        if ue.rx_power_db > self.target + 1:
            return 0      # -1 dB
        if ue.rx_power_db < self.target - 1:
            return 2      # +1 dB
        return 1          # 0 dB

    def schedule(self, ues: list, n_cce_used: int = 0,
                 msg3_active: bool = False, pid: int = 0) -> list:
        """ues: [UlUeState]; returns [UlGrant]. Retransmissions first (they
        keep their PRBs), then new TBs sized to the reported buffers, both
        gated by the remaining CCE budget and contiguous PRB space. `pid`
        is the synchronous HARQ process this TTI addresses (tti mod 8) —
        NDI state is per (rnti, pid) as in 36.321 §5.4.2.1."""
        grants = []
        n_cce_avail = self.n_cce_max - n_cce_used
        first_rb = 1                                   # PUCCH guard
        if msg3_active:
            first_rb += 1                              # Msg3 PRB skip
        agg = 1 << self.dci_L

        def cce_ok():
            return n_cce_avail >= agg

        # pass 1: HARQ retransmissions keep their allocation, rv cycles
        for ue in ues:
            if ue.retx_round > 0 and cce_ok():
                n = ue.retx_n_prb
                if first_rb + n > self.n_rb_ul:
                    continue
                grants.append(UlGrant(
                    rnti=ue.rnti, first_rb=first_rb, n_prb=n, mcs=ue.mcs,
                    rv=RV_SEQ[ue.retx_round & 3], tpc=self._tpc(ue),
                    ndi=self.ndi.get((ue.rnti, pid), 0),
                    cce_offset=(self.n_cce_max - n_cce_avail), L=self.dci_L))
                first_rb += n
                n_cce_avail -= agg

        # pass 2: new transmissions for UEs with data (BSR) or SR
        for ue in ues:
            if ue.retx_round > 0 or not cce_ok():
                continue
            if ue.buffer_bytes <= 0 and not ue.sr_pending:
                continue
            space = self.n_rb_ul - 1 - first_rb        # keep top PUCCH RB
            if space < 1:
                break
            want = max(ue.buffer_bytes, BSR_TABLE[1])
            idx = 0
            # walk rb_table until the TBS covers the buffer or space runs out
            while idx + 1 < len(RB_TABLE) and RB_TABLE[idx + 1] <= space \
                    and get_TBS_UL(ue.mcs, RB_TABLE[idx]) // 8 < want:
                idx += 1
            while idx > 0 and RB_TABLE[idx] > space:
                idx -= 1
            n = RB_TABLE[idx]
            if n > space:
                continue
            ndi = self.ndi.get((ue.rnti, pid), 0) ^ 1
            self.ndi[(ue.rnti, pid)] = ndi
            grants.append(UlGrant(
                rnti=ue.rnti, first_rb=first_rb, n_prb=n, mcs=ue.mcs,
                rv=0, tpc=self._tpc(ue), ndi=ndi,
                cce_offset=(self.n_cce_max - n_cce_avail), L=self.dci_L))
            first_rb += n
            n_cce_avail -= agg
        return grants

    def on_pusch_result(self, ue: UlUeState, grant: UlGrant, crc_ok: bool,
                        max_rounds: int = 4) -> None:
        """eNB-side HARQ bookkeeping after decoding a granted PUSCH."""
        if crc_ok or ue.retx_round + 1 >= max_rounds:
            if crc_ok:      # TB completed (any round) -> buffer served
                served = get_TBS_UL(grant.mcs, grant.n_prb) // 8
                ue.buffer_bytes = max(0, ue.buffer_bytes - served)
                ue.sr_pending = False
            ue.retx_round = 0
        else:
            ue.retx_round += 1
            ue.retx_first_rb = grant.first_rb
            ue.retx_n_prb = grant.n_prb
