"""UE per-subframe TX procedures: the full uplink subframe, assembled
(counterpart of openair4g_tpu/sched/ue_tx.py).

Reference parity: openair1/SCHED/phy_procedures_lte_ue.c:649
(phy_procedures_UE_TX: SRS/PUCCH/PUSCH selection per subframe,
ulsch_encoding + ulsch_modulation :931-996, PRACH trigger :1357-1460,
open-loop power control).

One [B, nsym, n_fft] grid per subframe; PUSCH, PUCCH and SRS are scatters
from maps built once on the host, then one IFFT and the +7.5 kHz shift.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..device import device_plan, resolve_device
from ..ops.gold import gold_sequence, pusch_cinit, scramble_bits
from ..ops.llr import map_symbols
from ..phy import ofdm
from ..phy.pdsch import DlschCodec
from ..phy.pucch import DATA_SYMS_F1, RS_SYMS_F1, pucch1_slot_symbols
from ..phy.pusch import UlschConfig
from ..phy.scfdma import apply_7_5_khz, make_pusch_map, pusch_fill_grid
from ..phy.srs import SrsConfig, srs_bins, srs_sequence
from ..phy.ulref import pusch_dmrs


@dataclass(frozen=True)
class UeUlConfig:
    """The reference's UeUlConfig fields and defaults, plus decoder_window
    (None: 96 on the CPU, 240 on a card) for the EnbRx that shares the
    codec."""
    n_rb: int = 25
    mcs: int = 10
    n_rb_alloc: int = 20
    rb_offset: int = 0
    rnti: int = 0x1234
    n_id_cell: int = 0
    subframe: int = 0
    srs: SrsConfig | None = None        # SRS on the last SC-FDMA symbol
    pucch_rb: int = 24                  # PUCCH resource RB (band edge)
    n_cs1: int = 0
    n_oc: int = 0
    n_turbo_iter: int = 6
    decoder_window: int | None = None


class UeTx:
    """Builds complete UL subframes on `device` (None: the card): PUSCH
    with its DMRS, or PUCCH format 1a/1b; an SRS when configured."""

    def __init__(self, cfg: UeUlConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        has_srs = cfg.srs is not None
        self.pm = make_pusch_map(cfg.n_rb, cfg.n_rb_alloc, cfg.rb_offset,
                                 srs=has_srs)
        g = len(self.pm.data_syms) * self.pm.m_sc * \
            UlschConfig(mcs=cfg.mcs, n_rb_alloc=cfg.n_rb_alloc).Qm
        self.ulsch = UlschConfig(mcs=cfg.mcs, n_rb_alloc=cfg.n_rb_alloc,
                                 n_turbo_iter=cfg.n_turbo_iter,
                                 decoder_window=cfg.decoder_window,
                                 g_override=g if has_srs else None)
        self.codec = DlschCodec(self.ulsch)
        self.dmrs = pusch_dmrs(self.pm.m_sc)
        cinit = pusch_cinit(cfg.rnti, 2 * cfg.subframe, cfg.n_id_cell)
        self.scr_seq = gold_sequence(cinit, self.ulsch.G)
        if has_srs:
            self._srs_bins = srs_bins(cfg.srs)
            self._srs_seq = srs_sequence(cfg.srs)
        # PUCCH geometry: RB at cfg.pucch_rb in slot 0, mirrored in slot
        # 1; per slot the bins and the format-1 data and RS references
        self._pucch_sc = [np.arange(12) + 12 * cfg.pucch_rb,
                          np.arange(12) + 12 * (cfg.n_rb - 1 - cfg.pucch_rb)]
        self._pucch = []
        for slot in (0, 1):
            data_ref, rs_ref = pucch1_slot_symbols(
                cfg.n_id_cell, 2 * cfg.subframe + slot, cfg.n_cs1, cfg.n_oc,
                1.0)
            self._pucch.append((
                torch.as_tensor(self.fp.sc_to_bin(self._pucch_sc[slot]),
                                dtype=torch.long, device=dev),
                torch.as_tensor(data_ref, device=dev),
                torch.as_tensor(rs_ref, device=dev)))

    # ------------------------------------------------------------- PUSCH --
    def pusch_subframe(self, tb_bits, rv: int = 0):
        """tb_bits [B, TBS] -> time waveform [B, samples]: encode at rv,
        scramble, map, transform-precode with the DMRS. When an SRS is
        configured, the last SC-FDMA symbol carries it and the PUSCH rate
        matching is shortened accordingly (map built with srs=True)."""
        dev = self.device
        e = self.codec.encode(tb_bits.to(dev), rv)
        sym = map_symbols(scramble_bits(e, self.scr_seq), self.ulsch.Qm)
        grid = pusch_fill_grid(sym, self.pm, self.dmrs)
        if self.cfg.srs is not None:
            last = self.fp.symbols_per_subframe - 1
            grid[:, last, device_plan(self._srs_bins, dev,
                                      dtype=torch.long)] = \
                device_plan(self._srs_seq, dev)
        t = ofdm.ofdm_modulate(grid, self.fp)
        return apply_7_5_khz(t, self.fp)

    # ------------------------------------------------------------- PUCCH --
    def pucch_subframe(self, d):
        """Format 1a/1b subframe: d [B] complex payload (+-1 BPSK for 1a,
        QPSK for 1b, 1.0 for SR). Returns waveform [B, samples]."""
        fp = self.fp
        d = d.to(self.device, torch.complex64)
        grid = torch.zeros(d.shape[0], fp.symbols_per_subframe, fp.n_fft,
                           dtype=torch.complex64, device=self.device)
        for slot, (bins, data_ref, rs_ref) in enumerate(self._pucch):
            base = slot * fp.symbols_per_slot
            for i, l in enumerate(DATA_SYMS_F1):
                grid[:, base + l, bins] = d[:, None] * data_ref[i]
            for i, l in enumerate(RS_SYMS_F1):
                grid[:, base + l, bins] = rs_ref[i]
        t = ofdm.ofdm_modulate(grid, fp)
        return apply_7_5_khz(t, fp)
