"""UE per-subframe RX procedures: the full downlink receiver (counterpart of
openair4g_tpu/sched/ue_rx.py).

Reference parity: openair1/SCHED/phy_procedures_lte_ue.c:2398
(phy_procedures_UE_RX: slot FEP, measurements, PBCH on subframe 0,
PCFICH -> CFI, PDCCH blind DCI search, rx_pdsch + dlsch_decoding, PHICH,
ACK/NACK generation).

One call from the received [B, nsym, n_fft] grid to the decoded TB and the
control decisions. The PCFICH, PDCCH and PDSCH LLRs come from the fused
MRC/LLR pass (the mrc_llr kernel on a card), each with n0 a number, which
goes in as the kernel's argument.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import wiener_stack_from_reference
from ..device import device_plan, resolve_device
from ..ops.equalize_llr import mrc_llr
from ..ops.gold import gold_sequence, pdsch_cinit, unscramble_llrs
from ..phy.channel_est import estimate_channel, make_wiener_stack
from ..phy.control_region import make_control_region_map
from ..phy.dci_formats import (dci_format1_size, dci_format1b_size,
                               dci_format1d_size, dci_format2_size,
                               dci_format2a_size)
from ..phy.measurements import measure
from ..phy.pdcch import (BITS_PER_CCE, cfi_decode, common_search_candidates,
                         dci_blind_decode, dci_format1a_size,
                         pdcch_scramble_seq, ue_search_candidates)
from ..phy.pdsch import DlschCodec, DlschConfig
from ..phy.phich import phich_group_rx, phich_reg_positions
from ..phy.resource_grid import make_grid_map
from .enb_tx import CellConfig, _long, _row0, pcfich_cinit


# 36.213 Table 7.1-5: the TM-specific DCI format searched in the
# UE-specific space (format 1A is always searched as well)
def tm_ue_format(tm: int, n_rb: int, n_tx: int = 2):
    """-> (format name, payload size) of the transmission mode's
    UE-specific-space DCI (dci.c:2788's per-TM size hypotheses)."""
    if tm in (1, 2, 7):
        return "1", dci_format1_size(n_rb)
    if tm == 3:
        return "2a", dci_format2a_size(n_rb, n_tx)
    if tm == 4:
        return "2", dci_format2_size(n_rb, n_tx)
    if tm == 5:
        return "1d", dci_format1d_size(n_rb, n_tx)
    if tm == 6:
        return "1b", dci_format1b_size(n_rb, n_tx)
    raise ValueError(f"TM{tm}")


def _signs(seq: np.ndarray) -> np.ndarray:
    return 1.0 - 2.0 * seq.astype(np.float32)


class UeRx:
    """Full-subframe receiver for one configured UE, on `device` (None: the
    card). decoder_window None: 96 on the CPU, 240 on a card."""

    def __init__(self, cfg: CellConfig, n_turbo_iter: int = 8,
                 tm: int = 1, n_tx: int = 2, device=None,
                 decoder_window: int | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        ns = 2 * cfg.subframe
        self.codec = DlschCodec(DlschConfig(
            mcs=cfg.mcs, n_rb=cfg.n_prb, n_pdcch_symbols=cfg.n_pdcch,
            n_turbo_iter=n_turbo_iter, decoder_window=decoder_window))
        self.gm = make_grid_map(cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell,
                                cfg.subframe)
        self.am = make_grid_map(cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell,
                                cfg.subframe,
                                rb_alloc=(cfg.rb_start, cfg.n_prb))
        if self.am.n_data_re * self.codec.cfg.Qm != self.codec.cfg.G:
            raise ValueError(f"allocation holds {self.am.n_data_re} data "
                             f"REs, G = {self.codec.cfg.G}")
        self.crm = make_control_region_map(
            cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell,
            n_phich_groups=cfg.n_phich_groups)
        self.scr_seq = gold_sequence(
            pdsch_cinit(cfg.rnti, 0, ns, cfg.n_id_cell), self.codec.cfg.G)
        self.pdcch_scr = pdcch_scramble_seq(cfg.n_id_cell, ns,
                                            self.crm.n_cce * BITS_PER_CCE)
        self.pcfich_scr = gold_sequence(pcfich_cinit(cfg.subframe,
                                                     cfg.n_id_cell), 32)
        # Multi-size blind search (dci_decoding_procedure, dci.c:2788):
        # the 0/1A size runs over the COMMON + UE-specific spaces; the
        # TM-specific format's size over the UE-specific space only.
        n_cce = self.crm.n_cce
        common = common_search_candidates(n_cce)
        uespec = ue_search_candidates(n_cce, cfg.rnti, cfg.subframe)
        both = common + [c for c in uespec if c not in common]
        size_1a = dci_format1a_size(cfg.n_rb, tdd=cfg.tdd)
        self.size_hyps = [("1a", size_1a, both)]
        fmt, size_tm = tm_ue_format(tm, cfg.n_rb, n_tx)
        if size_tm != size_1a:
            self.size_hyps.append((fmt, size_tm, uespec))
        self.tm = tm
        # the 1A hypothesis alone, which FullChainSim drives
        self.candidates = both
        self.dci_len = size_1a
        self.phich_sc = phich_reg_positions(cfg.n_rb, cfg.n_id_cell,
                                            cfg.n_phich_groups)
        fp = self.gm.fp
        self.phich_bin = fp.sc_to_bin(self.phich_sc.reshape(-1)).reshape(
            self.phich_sc.shape)

    def make_wiener(self, n0: float):
        """The time-averaged estimator's Wiener stack (noise n0 / 4) on the
        device, complex64 [n_ps, Np, n_sc]."""
        return wiener_stack_from_reference(
            make_wiener_stack(self.gm, float(n0) / 4.0), self.device)

    # ---------------------------------------------------------- pieces --
    def channel(self, rgrid, wiener):
        """The pilot-symbol-averaged channel estimate [B, nsym, n_sc]."""
        return estimate_channel(rgrid, self.gm, wiener, time_avg=True)

    def _eq_llr(self, rgrid, H, sym, bins, sc, n0: float, Qm: int):
        """Fused compensation, equalization and demap of one channel's REs
        (ops/equalize_llr): [B, n_re * Qm]."""
        dev = rgrid.device
        s = _long(sym, dev)
        y = rgrid[:, s, _long(bins, dev)]
        h = H[:, s, _long(sc, dev)]
        return mrc_llr(y[..., None], h[..., None], n0, Qm).reshape(
            rgrid.shape[0], -1)

    def pcfich_llrs(self, rgrid, H, n0: float):
        """Descrambled PCFICH LLRs [B, 32]."""
        crm = self.crm
        return self._eq_llr(rgrid, H, crm.pcfich_sym, crm.pcfich_bin,
                            crm.pcfich_sc, n0, 2) \
            * device_plan(self.pcfich_scr, rgrid.device, _signs)

    def pdcch_llrs(self, rgrid, H, n0: float):
        """Descrambled control-region LLRs [B, n_cce * 72]."""
        crm = self.crm
        return self._eq_llr(rgrid, H, crm.pdcch_sym, crm.pdcch_bin,
                            crm.pdcch_sc, n0, 2) \
            * device_plan(self.pdcch_scr, rgrid.device, _signs)

    def pdsch_llrs(self, rgrid, H, n0: float):
        """Descrambled PDSCH LLRs [B, G], the decoder's input."""
        am = self.am
        llr = self._eq_llr(rgrid, H, am.data_sym, am.data_bin, am.data_sc,
                           n0, self.codec.cfg.Qm)
        return unscramble_llrs(llr, self.scr_seq)

    def phich(self, rgrid, H, n0: float):
        """Group 0, sequence 0: (z [B] complex decision variable, ACK [B]
        bool)."""
        dev = rgrid.device
        cfg = self.cfg
        yp = rgrid[:, 0, device_plan(self.phich_bin, dev, _row0, torch.long)]
        hp = H[:, 0, device_plan(self.phich_sc, dev, _row0, torch.long)]
        yeq = yp * torch.conj(hp) / (hp.abs() ** 2 + n0)
        z = phich_group_rx(yeq, cfg.n_id_cell, 2 * cfg.subframe)[:, 0]
        return z, z.real > 0

    # ---------------------------------------------------------- receive --
    def receive(self, rgrid, n0, wiener):
        """rgrid [B, nsym, n_fft] -> dict with cfi_hat, dci_found,
        dci_payload, dci (every size hypothesis: format -> (found,
        payload)), tb, tb_ok, ack (= tb_ok gated on the DCI), phich_ack
        and the measurements."""
        cfg = self.cfg
        n0 = float(np.float32(n0))
        rgrid = rgrid.to(self.device)
        H = self.channel(rgrid, wiener)
        meas = measure(rgrid, self.gm, H_hat=H)
        cfi_hat, _ = cfi_decode(self.pcfich_llrs(rgrid, H, n0))

        llr_pdcch = self.pdcch_llrs(rgrid, H, n0)
        dcis = {}
        for fmt, size, cands in self.size_hyps:
            f, p, _ = dci_blind_decode(llr_pdcch, size, cfg.rnti, cands)
            dcis[fmt] = (f, p)
        found, payload = dcis["1a"]

        _, phich_ack = self.phich(rgrid, H, n0)
        tb, tb_ok, _ = self.codec.decode(self.pdsch_llrs(rgrid, H, n0))
        return dict(cfi_hat=cfi_hat, dci_found=found, dci_payload=payload,
                    dci=dcis, tb=tb, tb_ok=tb_ok, ack=found & tb_ok,
                    phich_ack=phich_ack, meas=meas)
