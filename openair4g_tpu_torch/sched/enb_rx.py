"""eNB per-subframe RX procedures: PUSCH + PUCCH + SRS receiver and HARQ
feedback bookkeeping (counterpart of openair4g_tpu/sched/enb_rx.py).

Reference parity: openair1/SCHED/phy_procedures_lte_eNb.c:3207
(phy_procedures_eNB_RX: per-UE rx_ulsch + ulsch_decoding, rx_pucch, SRS
estimates), process_HARQ_feedback :2658 and the UE-drop rule after
ULSCH_max_consecutive_errors :1415-1422.

Each channel's receiver is a static gather and batched tensor work on the
grid; the PUSCH's inverse channel interleaver is the map's static plan.
The HARQ state (round counters, the consecutive-error drop) is host
bookkeeping, as in the reference's eNB structs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import device_plan
from ..ops.gold import unscramble_llrs
from ..ops.llr import demap_llr
from ..phy import ofdm
from ..phy.pucch import DATA_SYMS_F1, RS_SYMS_F1, pucch1_detect
from ..phy.pusch import (make_ul_wiener, scfdma_mmse_equalize,
                         ul_estimate_channel)
from ..phy.scfdma import pusch_extract, remove_7_5_khz, transform_deprecode
from ..phy.srs import srs_estimate


class EnbRx:
    """Uplink receiver bound to one UeTx configuration (grant knowledge),
    on the UeTx's device."""

    def __init__(self, ue_tx):
        self.tx = ue_tx            # sched.ue_tx.UeTx: shares maps/codec
        self.fp = ue_tx.fp
        self.pm = ue_tx.pm
        self.codec = ue_tx.codec
        self.device = ue_tx.device

    def wiener(self, n0: float):
        """The DMRS estimator's [M, M] smoothing matrix on the device."""
        return make_ul_wiener(self.pm, float(n0), self.device)

    def pusch_llrs(self, waveform, n0, wiener=None):
        """waveform [B, samples] -> (descrambled data LLRs [B, G], the
        received grid [B, nsym, n_fft])."""
        if wiener is None:
            wiener = self.wiener(n0)
        n0 = float(np.float32(n0))
        waveform = waveform.to(self.device)
        t = remove_7_5_khz(waveform, self.fp)
        rgrid = ofdm.ofdm_demodulate(t, self.fp)
        y, dmrs_rx = pusch_extract(rgrid, self.pm)
        H = ul_estimate_channel(dmrs_rx, self.tx.dmrs, self.pm, wiener)
        xf, n0_eff = scfdma_mmse_equalize(y, H, n0)
        Qm = self.tx.ulsch.Qm
        llr = demap_llr(transform_deprecode(xf), n0_eff, Qm)
        B = llr.shape[0]
        inv = device_plan(self.pm.deinterleave, rgrid.device,
                          dtype=torch.long)
        llr = llr.reshape(B, -1, Qm)[:, inv].reshape(B, -1)
        return unscramble_llrs(llr, self.tx.scr_seq), rgrid

    def receive_pusch(self, waveform, n0, wiener=None):
        """waveform [B, samples] -> (tb [B, TBS], ok [B], the SRS estimate
        (H_hat, snr_db, t_off) or None)."""
        llr, rgrid = self.pusch_llrs(waveform, n0, wiener)
        tb, ok, _ = self.codec.decode(llr)
        srs = None
        if self.tx.cfg.srs is not None:
            last = self.fp.symbols_per_subframe - 1
            srs = srs_estimate(rgrid[:, last], self.tx.cfg.srs)
        return tb, ok, srs

    def receive_pucch(self, waveform, n0):
        """Format 1a/1b detection -> z [B], the decision variable summed
        over both slots."""
        cfg, fp = self.tx.cfg, self.fp
        t = remove_7_5_khz(waveform.to(self.device), fp)
        rgrid = ofdm.ofdm_demodulate(t, fp)
        z_tot = None
        for slot, (bins, _, _) in enumerate(self.tx._pucch):
            base = slot * fp.symbols_per_slot
            rx_data = torch.stack([rgrid[:, base + l, bins]
                                   for l in DATA_SYMS_F1], dim=1)
            rx_rs = torch.stack([rgrid[:, base + l, bins]
                                 for l in RS_SYMS_F1], dim=1)
            z, _ = pucch1_detect(rx_data, rx_rs, cfg.n_id_cell,
                                 2 * cfg.subframe + slot, cfg.n_cs1,
                                 cfg.n_oc)
            z_tot = z if z_tot is None else z_tot + z
        return z_tot


@dataclass
class HarqFeedbackState:
    """Per-UE uplink HARQ bookkeeping (process_HARQ_feedback + the drop
    rule of phy_procedures_lte_eNb.c:1415)."""
    max_rounds: int = 4
    max_consecutive_errors: int = 20
    round: int = 0
    consecutive_errors: int = 0
    dropped: bool = False
    n_ack: int = 0
    n_nack: int = 0

    def feedback(self, crc_ok: bool) -> dict:
        """One TTI's decode outcome -> action for the scheduler."""
        if self.dropped:
            return dict(action="dropped", rv=0)
        if crc_ok:
            self.n_ack += 1
            self.consecutive_errors = 0
            self.round = 0
            return dict(action="new_tx", rv=0)
        self.n_nack += 1
        self.consecutive_errors += 1
        if self.consecutive_errors >= self.max_consecutive_errors:
            self.dropped = True              # UE lost: trigger RA again
            return dict(action="dropped", rv=0)
        self.round += 1
        if self.round >= self.max_rounds:
            self.round = 0                   # TB lost: hand to RLC ARQ
            return dict(action="new_tx", rv=0)
        rv = (0, 2, 3, 1)[self.round & 3]    # 36.213 rv cycle
        return dict(action="retx", rv=rv)
