"""eNB MAC downlink scheduler: proportional-fair with HARQ-retx priority.

Reference parity: openair2/LAYER2/MAC/eNB_scheduler.c:80
(eNB_dlsch_ulsch_scheduler — per-TTI passes: SI/RA first, pending HARQ
retransmissions, then new transmissions via the pre-processor's
proportional-fair RB split, pre_processor.c) and eNB_scheduler_dlsch.c
(CQI -> MCS selection, DCI construction).

Host-side control code (the reference's is too): per-TTI decisions over a
handful of UEs; the data path it drives is the batched device PHY.

A copy of openair4g_tpu/mac/scheduler.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# CQI index -> highest MCS whose spectral efficiency fits (36.213 Table
# 7.2.3-1 mapped through the MCS efficiency ladder; reference
# get_mcs_from_cqi-style mapping)
CQI_TO_MCS = (0, 0, 0, 2, 4, 6, 8, 11, 13, 16, 18, 21, 23, 25, 27, 28)


@dataclass
class UeContext:
    """Per-UE MAC state (subset of the reference's UE_list entry)."""
    rnti: int
    cqi: int = 7
    avg_thr: float = 1.0          # EWMA throughput (bits/TTI)
    pending_retx: bool = False
    retx_rv: int = 0
    harq_round: int = 0
    buffer_bits: int = 1 << 30    # full buffer by default
    drx: bool = False


@dataclass(frozen=True)
class Allocation:
    rnti: int
    rb_start: int
    n_prb: int
    mcs: int
    ndi: int
    rv: int


class PfScheduler:
    """Proportional-fair DL scheduler over one carrier."""

    def __init__(self, n_rb: int, ewma: float = 0.05,
                 min_prb: int = 2, max_ues_per_tti: int = 4):
        self.n_rb = n_rb
        self.ewma = ewma
        self.min_prb = min_prb
        self.max_ues = max_ues_per_tti

    def _rate_estimate(self, ue: UeContext, n_prb: int) -> float:
        """Achievable bits for n_prb at the UE's CQI (TBS lookup)."""
        from ..tables.tbs import get_TBS_DL
        mcs = CQI_TO_MCS[min(ue.cqi, 15)]
        return float(get_TBS_DL(mcs, max(n_prb, 1)))

    def schedule(self, ues: list, tti: int) -> list:
        """-> list[Allocation]; updates EWMA throughputs in place.

        Pass 1: HARQ retransmissions keep their grant (reference: retx
        scheduled before new data). Pass 2: PF metric r_inst/avg_thr ranks
        the remaining UEs; RBs split evenly among the winners.
        """
        allocs = []
        rb_free = self.n_rb
        rb_next = 0
        active = [u for u in ues if not u.drx and u.buffer_bits > 0]

        # ---- pass 1: pending retransmissions ----------------------------
        retx = [u for u in active if u.pending_retx]
        for u in retx[: self.max_ues]:
            n_prb = min(self.n_rb // max(len(retx), 1), rb_free)
            if n_prb < self.min_prb:
                break
            mcs = CQI_TO_MCS[min(u.cqi, 15)]
            allocs.append(Allocation(u.rnti, rb_next, n_prb, mcs,
                                     ndi=0, rv=u.retx_rv))
            rb_next += n_prb
            rb_free -= n_prb

        # ---- pass 2: proportional fair for new transmissions -------------
        fresh = [u for u in active if not u.pending_retx]
        if fresh and rb_free >= self.min_prb:
            n_win = min(self.max_ues - len(allocs), len(fresh))
            if n_win > 0:
                prb_each = max(rb_free // n_win, self.min_prb)
                scored = sorted(
                    fresh,
                    key=lambda u: -self._rate_estimate(u, prb_each)
                    / max(u.avg_thr, 1e-9))
                for u in scored[:n_win]:
                    n_prb = min(prb_each, rb_free)
                    if n_prb < self.min_prb:
                        break
                    mcs = CQI_TO_MCS[min(u.cqi, 15)]
                    allocs.append(Allocation(u.rnti, rb_next, n_prb, mcs,
                                             ndi=1, rv=0))
                    rb_next += n_prb
                    rb_free -= n_prb

        # ---- EWMA update (scheduled UEs get their rate; others decay) ----
        granted = {a.rnti: a for a in allocs}
        for u in ues:
            r = 0.0
            if u.rnti in granted:
                a = granted[u.rnti]
                from ..tables.tbs import get_TBS_DL
                r = float(get_TBS_DL(a.mcs, a.n_prb))
            u.avg_thr = (1 - self.ewma) * u.avg_thr + self.ewma * r
        return allocs

    def harq_feedback(self, ue: UeContext, ack: bool,
                      max_rounds: int = 4) -> None:
        """ACK/NACK from the UE -> retx bookkeeping (36.213 rv cycle)."""
        if ack:
            ue.pending_retx = False
            ue.harq_round = 0
            return
        ue.harq_round += 1
        if ue.harq_round >= max_rounds:
            ue.pending_retx = False       # TB lost -> RLC
            ue.harq_round = 0
        else:
            ue.pending_retx = True
            ue.retx_rv = (0, 2, 3, 1)[ue.harq_round & 3]
