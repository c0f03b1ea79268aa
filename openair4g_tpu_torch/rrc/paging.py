"""Paging occasions + PCCH scheduling (36.304 §7, 36.331 PCCH-Config).

Reference parity: rrc_UE.c:2303,2755 (defaultPagingCycle from SIB2's
pcch-Config), the P-RNTI common-search DCI 1C path in dci.c, and the MME's
S1AP Paging toward every eNB in the tracking area. The UE sleeps between
its own paging occasions (idle-mode DRX) and wakes only to decode the
P-RNTI PDSCH at (PF, PO).

36.304 math:
  T  = DRX cycle in frames (rf32/64/128/256 from defaultPagingCycle)
  nB in {4T, 2T, T, T/2, T/4, T/8, T/16, T/32}
  N  = min(T, nB); Ns = max(1, nB/T)
  UE_ID = IMSI mod 1024
  PF: SFN mod T == (T div N) * (UE_ID mod N)
  i_s = floor(UE_ID / N) mod Ns -> PO subframe via Table 7.2 (FDD).

A copy of openair4g_tpu/rrc/paging.py.
"""
from __future__ import annotations

from dataclasses import dataclass

DRX_CYCLE_FRAMES = (32, 64, 128, 256)         # defaultPagingCycle index
NB_FACTOR = (4.0, 2.0, 1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125)

# 36.304 Table 7.2-1 (FDD): PO subframe for Ns x i_s
_PO_TABLE = {1: (9,), 2: (4, 9), 4: (0, 4, 5, 9)}


@dataclass(frozen=True)
class PagingConfig:
    default_paging_cycle: int = 1             # SIB2 index -> rf64
    paging_nb: int = 2                        # SIB2 index -> nB = T

    @property
    def T(self) -> int:
        return DRX_CYCLE_FRAMES[self.default_paging_cycle]

    @property
    def nB(self) -> float:
        return self.T * NB_FACTOR[self.paging_nb]

    @classmethod
    def from_sib2(cls, sib2) -> "PagingConfig":
        return cls(default_paging_cycle=sib2.default_paging_cycle,
                   paging_nb=sib2.paging_nb)


def ue_paging_id(imsi: int) -> int:
    """UE_ID = IMSI mod 1024 (36.304 §7.1)."""
    return imsi % 1024


def paging_frame_offset(cfg: PagingConfig, ue_id: int) -> int:
    """The PF satisfies SFN mod T == this offset."""
    N = min(cfg.T, int(cfg.nB)) or 1
    return (cfg.T // N) * (ue_id % N)


def paging_subframe(cfg: PagingConfig, ue_id: int) -> int:
    """PO subframe within the PF (FDD Table 7.2-1)."""
    N = min(cfg.T, int(cfg.nB)) or 1
    ns = max(1, int(cfg.nB // cfg.T))
    i_s = (ue_id // N) % ns
    return _PO_TABLE[ns][i_s]


def is_paging_occasion(cfg: PagingConfig, ue_id: int, sfn: int,
                       subframe: int) -> bool:
    """True when (sfn, subframe) is this UE's paging occasion — the only
    TTIs an idle UE monitors the P-RNTI (idle DRX)."""
    return (sfn % cfg.T == paging_frame_offset(cfg, ue_id)
            and subframe == paging_subframe(cfg, ue_id))


def next_paging_occasion(cfg: PagingConfig, ue_id: int, tti: int) -> int:
    """First TTI >= tti that is the UE's paging occasion (for eNB-side
    scheduling of a queued page)."""
    for t in range(tti, tti + 10 * cfg.T + 10):
        if is_paging_occasion(cfg, ue_id, t // 10, t % 10):
            return t
    raise AssertionError("no paging occasion within one DRX cycle")
