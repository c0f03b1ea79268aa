"""eNB per-subframe TX procedures: the full downlink subframe, assembled
(counterpart of openair4g_tpu/sched/enb_tx.py).

Reference parity: openair1/SCHED/phy_procedures_lte_eNb.c:1372
(phy_procedures_eNB_TX: per subframe PSS/SSS/pilots/PBCH, DCIs via
generate_dci_top, PDSCH encode->scramble->modulate, PHICH; then OFDM mod).

The channels' RE coordinates and static symbols are built on the host once
per cell; a batch of subframes is a handful of scatters into the
[B, 14, n_fft] grid and one batched IFFT on the device. The PDCCH symbols
change whenever a DCI payload is set (a TDD frame sets one every D
subframe), so they are uploaded when set, not kept as a static plan.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..device import device_plan, resolve_device
from ..ops.gold import gold_sequence
from ..phy import ofdm
from ..phy.control_region import make_control_region_map
from ..phy.pbch import make_pbch_map, pack_mib, pbch_frame_symbols
from ..phy.pdcch import (BITS_PER_CCE, cfi_encode, dci_encode,
                         dci_format1a_size, pack_dci_format1a,
                         pdcch_scramble_seq)
from ..phy.phich import _W, phich_reg_positions, phich_scramble
from ..phy.resource_grid import fill_grid, make_grid_map
from ..phy.sync import center62_bins, pss_sequence, sss_sequence


@dataclass(frozen=True)
class CellConfig:
    """Static cell + scheduling configuration for the full-chain procedures."""
    n_rb: int = 25
    n_id_cell: int = 0
    n_pdcch: int = 3
    n_phich_groups: int = 1
    rnti: int = 0x1234
    # the one scheduled UE's PDSCH allocation (DCI format 1A, type-2 VRB)
    rb_start: int = 0
    n_prb: int = 25
    mcs: int = 4
    dci_L: int = 4
    dci_cce_offset: int = 0
    subframe: int = 7
    tdd: bool = False        # TDD cell: 1A carries 4-bit HARQ + 2-bit DAI


def _qpsk(bits: np.ndarray) -> np.ndarray:
    return (((1 - 2 * bits[0::2]) + 1j * (1 - 2 * bits[1::2]))
            / np.sqrt(2)).astype(np.complex64)


def pcfich_cinit(subframe: int, nid_cell: int) -> int:
    """36.211 §6.7.1: c_init = (ns/2 + 1)(2 N_ID + 1) 2^9 + N_ID."""
    return ((subframe + 1) * (2 * nid_cell + 1) << 9) + nid_cell


def _long(a: np.ndarray, dev) -> torch.Tensor:
    return device_plan(a, dev, dtype=torch.long)


def _row0(a: np.ndarray) -> np.ndarray:
    return a[0]


class EnbTx:
    """Builds complete DL subframes for one cell, batched over trials, on
    `device` (None: the card)."""

    def __init__(self, cfg: CellConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        ns = 2 * cfg.subframe
        self.crm = make_control_region_map(
            cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell,
            n_phich_groups=cfg.n_phich_groups)
        # full-band map (pilots) and the PDSCH allocation map (data REs)
        self.gm = make_grid_map(cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell,
                                cfg.subframe)
        self.am = make_grid_map(cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell,
                                cfg.subframe,
                                rb_alloc=(cfg.rb_start, cfg.n_prb))

        # ---- PCFICH (36.211 §6.7) --------------------------------------
        b = cfi_encode(cfg.n_pdcch) ^ gold_sequence(
            pcfich_cinit(cfg.subframe, cfg.n_id_cell), 32).astype(np.int8)
        self.pcfich_syms = _qpsk(b)
        self._pcfich = torch.as_tensor(self.pcfich_syms, device=dev)

        # ---- PDCCH: one DCI format 1A for the scheduled UE --------------
        n_cce = self.crm.n_cce
        if cfg.dci_cce_offset + cfg.dci_L > n_cce:
            raise ValueError(f"DCI at CCE {cfg.dci_cce_offset} L "
                             f"{cfg.dci_L} outside {n_cce} CCEs")
        self.pdcch_scr = pdcch_scramble_seq(cfg.n_id_cell, ns,
                                            n_cce * BITS_PER_CCE)
        self.set_dci_payload(pack_dci_format1a(
            cfg.n_rb, rb_start=cfg.rb_start, n_prb=cfg.n_prb, mcs=cfg.mcs,
            harq_pid=0, ndi=1, rv=0, tdd=cfg.tdd))
        if len(self.dci_payload) != dci_format1a_size(cfg.n_rb, tdd=cfg.tdd):
            raise ValueError("format 1A payload of the wrong size")

        # ---- PHICH group 0 geometry -------------------------------------
        self.phich_sc = phich_reg_positions(cfg.n_rb, cfg.n_id_cell,
                                            cfg.n_phich_groups)   # [G, 12]
        self.phich_bin = self.fp.sc_to_bin(self.phich_sc.reshape(-1)).reshape(
            self.phich_sc.shape)
        # spreading of sequence 0, for a per-trial ACK bit on the device
        c = phich_scramble(cfg.n_id_cell, ns)
        self._phich_seq0 = torch.as_tensor(
            (np.tile(_W[0], 3) * c / np.sqrt(2)).astype(np.complex64),
            device=dev)

    def set_dci_payload(self, payload: np.ndarray) -> None:
        """(Re)encode the PDCCH with an arbitrary DCI payload (any format
        of the 1A/0 size class, or other sizes that fit dci_L CCEs): lets
        sims carry UL grants (format 0) or MIMO grants through the same
        control region."""
        cfg = self.cfg
        self.dci_payload = np.asarray(payload, np.int8)
        self.set_dcis([(self.dci_payload, cfg.rnti, cfg.dci_L,
                        cfg.dci_cce_offset)])

    def set_dcis(self, dcis) -> None:
        """Encode multiple DCIs into the control region; `dcis` is a list of
        (payload_bits, rnti, L, cce_offset). Mirrors generate_dci_top
        (dci.c:2084-2096: per-DCI CC encode + CRC16 masked by RNTI, NIL
        CCEs at zero power). Overlapping CCEs raise ValueError."""
        n_cce = self.crm.n_cce
        full = np.zeros(n_cce * BITS_PER_CCE, np.int8)
        used = np.zeros(n_cce * BITS_PER_CCE // 2, bool)
        for payload, rnti, L, cce_offset in dcis:
            if cce_offset + L > n_cce:
                raise ValueError(f"DCI at CCE {cce_offset} L {L} outside "
                                 f"{n_cce} CCEs")
            e = dci_encode(np.asarray(payload, np.int8), rnti, L)
            s = cce_offset * BITS_PER_CCE
            if used[s // 2:(s + len(e)) // 2].any():
                raise ValueError(f"CCE overlap at CCE {cce_offset} L {L}")
            full[s:s + len(e)] = e ^ self.pdcch_scr[s:s + len(e)]
            used[s // 2:(s + len(e)) // 2] = True
        self.pdcch_syms = np.where(used, _qpsk(full), 0).astype(np.complex64)
        self._pdcch = torch.as_tensor(self.pdcch_syms, device=self.device)

    # -------------------------------------------------------------- build --
    def data_subframe(self, pdsch_syms, ack_bits=None):
        """pdsch_syms [B, n_alloc_re] complex, ack_bits [B] in {0,1} or None
        -> grid [B, nsym, n_fft] with pilots + PCFICH + PHICH + PDCCH +
        PDSCH."""
        dev, crm, am = self.device, self.crm, self.am
        B = pdsch_syms.shape[0]
        grid = fill_grid(torch.zeros(B, self.gm.n_data_re,
                                     dtype=torch.complex64, device=dev),
                         self.gm)
        grid[:, _long(am.data_sym, dev), _long(am.data_bin, dev)] = \
            pdsch_syms.to(dev, torch.complex64)
        grid[:, _long(crm.pcfich_sym, dev), _long(crm.pcfich_bin, dev)] = \
            self._pcfich
        grid[:, _long(crm.pdcch_sym, dev), _long(crm.pdcch_bin, dev)] = \
            self._pdcch
        if ack_bits is not None:
            hi = 2.0 * ack_bits.to(dev, torch.float32) - 1.0   # ACK +1
            grid[:, 0, device_plan(self.phich_bin, dev, _row0, torch.long)] \
                = hi[:, None] * self._phich_seq0[None, :]
        return grid

    def data_waveform(self, pdsch_syms, ack_bits=None):
        return ofdm.ofdm_modulate(self.data_subframe(pdsch_syms, ack_bits),
                                  self.fp)

    # ---------------------------------------------------- subframe 0 (sync) --
    @functools.lru_cache(maxsize=4)
    def sync_subframe_host(self, sfn: int = 0) -> np.ndarray:
        """Host-built subframe-0 grid [nsym, n_fft]: PSS (sym 6), SSS (sym
        5), PBCH quarter (slot-1 syms 0..3) + pilots. One per SFN phase."""
        cfg, fp = self.cfg, self.fp
        gm0 = make_grid_map(cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell, subframe=0)
        grid = np.zeros((fp.symbols_per_subframe, fp.n_fft), np.complex64)
        grid[gm0.pilot_sym, gm0.pilot_bin] = gm0.pilot_val
        bins = center62_bins(fp)
        nid1, nid2 = cfg.n_id_cell // 3, cfg.n_id_cell % 3
        grid[5, bins] = sss_sequence(nid1, nid2, False)
        grid[6, bins] = pss_sequence(nid2)
        pm = make_pbch_map(cfg.n_rb, cfg.n_id_cell)
        mib = pack_mib(cfg.n_rb, sfn)
        grid[pm.sym, pm.bins] = pbch_frame_symbols(mib, cfg.n_id_cell,
                                                   sfn % 4)
        return grid
