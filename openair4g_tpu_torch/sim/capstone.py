"""Capstone full-stack over-the-air emulation: one UE goes from cold RF
capture to EMM-REGISTERED with a running default bearer, every control and
user message traversing the PHY (counterpart of
openair4g_tpu/sim/capstone.py).

The ladder (reference flow: targets/SIMU/USER/oaisim.c:760-938 per-TTI
loop; openair2/RRC/LITE/rrc_eNB.c CCCH/DCCH handling;
openair-cn s1ap_eNB_nas_procedures.c):

  PSS/SSS sync + PBCH MIB          (initial_sync.c:274)
  SIB1/SIB2 on PDSCH via DCI 1C    (SI-RNTI common search, dci.c:2805)
  PRACH preamble                   (prach.c:598/1061)
  RAR via DCI 1C @ RA-RNTI         (eNB_scheduler_RA.c, rar_tools.c)
  Msg3 RRCConnectionRequest on the RAR-granted PUSCH, as a CCCH SDU in a
    MAC PDU (36.321 mux)           (ue_procedures.c ue_get_sdu)
  Msg4 = Contention-Resolution CE + RRCConnectionSetup     (36.321 §5.1.5)
  SetupComplete w/ NAS AttachRequest on SRB1 through RLC-AM (rrc_eNB.c ->
    S1AP InitialUEMessage)
  NAS auth / security / AttachAccept riding DL/ULInformationTransfer on
    SRB1, MME behind S1AP           (openair-cn MME_APP ladder)
  RRCConnectionReconfiguration adds the DRB (RLC-UM + PDCP)
  One IP packet UE->PDCP->RLC->MAC->PHY->eNB->GTP-U->SGW and echoed back.

Every DL TTI is a complete subframe (pilots, PCFICH, PDCCH, PDSCH) built
by sched/enb_tx and received blind by the UE (CFI region -> common-search
DCI 1C hypotheses for SI/RA/P-RNTI + UE-search 1A/format-0 for the
C-RNTI); every UL TTI is a complete SC-FDMA subframe (sched/ue_tx ->
sched/enb_rx). UL grants ride in-band DCI format 0 (the 1A/0 size class,
flag-bit dispatched). Two emulation shortcuts, both with tested in-band
counterparts elsewhere: the scheduling request is carried as a host flag
(PUCCH format-1 SR detection is exercised in sim/pucchsim.py) and
subframes with nothing scheduled skip the PHY (they would be
pilots+PCFICH only).

The PHY runs on the sim's device (None: the card); the protocol stack,
the MAC/RLC/PDCP, RRC and EPC are host Python, as in the reference. All
noise is drawn on the host from numpy Generators seeded from cfg.seed, in
the reference's order, and added to the clean wave on the host before
the upload, so a run consumes the reference's draws. The waves come to
the host for that sum, and the decoders' flags and payloads for the
protocol's decisions: a handful of syncs a TTI, as in the reference.

Artifacts (VERDICT round-2 item 5): LOG_* lines via utils/log, MAC/NAS/IP
pcap via utils/opt, message sequence chart via utils/msc.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import FrameParms
from ..convert import wiener_stack_from_reference
from ..device import device_plan, resolve_device
from ..sched.enb_tx import CellConfig, EnbTx
from ..sched.ue_tx import UeUlConfig, UeTx
from ..sched.enb_rx import EnbRx
from ..phy import ofdm
from ..phy.sync import CellSearch
from ..phy.pbch import make_pbch_map, pbch_blind_decode, unpack_mib
from ..phy.resource_grid import make_grid_map
from ..phy.channel_est import make_wiener_stack, estimate_channel
from ..phy.pdcch import (common_search_candidates, ue_search_candidates,
                         dci_blind_decode, pdcch_scramble_seq,
                         dci_format1a_size, pack_dci_format1a,
                         unpack_dci_format1a, BITS_PER_CCE)
from ..phy.dci_formats import (pack_dci_format1c, unpack_dci_format1c,
                               dci_format1c_size, pack_dci_format0,
                               unpack_dci_format0)
from ..phy.pdsch import DlschConfig, DlschCodec
from ..phy.prach import (preamble_freq, n_preambles, N_ZC,
                         NCS_UNRESTRICTED,
                         prach_time_generate, prach_time_detect,
                         prach_samples_per_seq)
from ..ops.gold import gold_sequence, pdsch_cinit, scramble_bits, \
    unscramble_llrs
from ..ops.llr import map_symbols, demap_llr
from ..mac.mux import (pack_mac_pdu, unpack_mac_pdu,
                       pack_contention_resolution,
                       contention_resolution_matches, LCID_CCCH,
                       LCID_CONTENTION_RESOLUTION, LCID_SHORT_BSR)
from ..mac.ra import Rar, pack_rar, unpack_rar, ra_rnti, \
    timing_advance_from_delay, RaProcedure
from ..mac.rlc import (RlcAm, RlcUm, StatusPdu, pack_am, unpack_am,
                       pack_am_status, pack_um, unpack_um)
from ..mac.ue_mac import pack_short_bsr
from ..mac.pdcp import PdcpEntity, PdcpConfig
from ..rrc.enb import RrcEnb, UeState
from ..rrc.ue import RrcUe, RrcState
from ..rrc.messages import (Mib, Sib1, Sib2, RrcConnectionSetupComplete,
                            RrcConnectionReconfiguration,
                            DlInformationTransfer, UlInformationTransfer,
                            SecurityModeCommand, SecurityModeComplete,
                            decode_message)
from ..epc.security import derive_k_rrc_int
from ..epc.hss import Hss
from ..epc.mme import Mme
from ..epc.sgw import SgwPgw
from ..epc.enb_app import EnbApp
from ..epc.ue_nas import UeNas, UeEmmState
from ..utils.log import LOG_I, LOG_D, LOG_W
from ..utils.msc import Msc
from ..utils.opt import PcapWriter, KIND_MAC, KIND_IP, DIR_DL, DIR_UL

SI_RNTI = 0xFFFF
P_RNTI = 0xFFFE

LCID_SRB1 = 1
LCID_DRB = 3


@dataclass(frozen=True)
class Alloc:
    rb_start: int
    n_prb: int
    mcs: int


@dataclass(frozen=True)
class CapstoneConfig:
    """The reference's CapstoneConfig fields and defaults, plus
    decoder_window."""
    n_rb: int = 25
    n_pdcch: int = 3
    n_id_cell: int = 0
    snr_db: float = 12.0
    seed: int = 0
    common: Alloc = Alloc(0, 4, 2)       # SI/RAR/Paging via DCI 1C
    ded: Alloc = Alloc(8, 6, 8)          # Msg4/DCCH/DRB via DCI 1A
    msg3: Alloc = Alloc(0, 4, 4)         # RAR UL grant
    ul: Alloc = Alloc(0, 6, 8)           # dedicated UL grants (DCI 0)
    prach_sf: int = 1                    # PRACH occasion subframe
    prach_root: int = 129
    prach_ncs: int = 13
    prach_delay: int = 5                 # ZC samples (cell radius)
    imsi: int = 208950000000001
    k: bytes = bytes(range(16))
    max_ttis: int = 400
    n_turbo_iter: int = 8
    mt_attach: bool = False     # mobile-terminated: UE camps idle and
    #   waits for a P-RNTI page at its 36.304 paging occasion before RA
    page_at_tti: int = 16       # when the MME pages (mt_attach mode)
    paging_cycle_idx: int = 1   # SIB2 defaultPagingCycle: rf{32,64,128,256}
    big_nas_bytes: int = 0      # >0: after registration the MME sends an
    #   EMM INFORMATION this big — a DL NAS message larger than any MAC
    #   grant, carried by RLC-AM segmentation across TTIs (VERDICT r3
    #   item 6 acceptance: 400+B NAS over ~100B grants)
    decoder_window: int | None = None   # the turbo decoder's window (None:
    #   96 on the CPU, 240 on a card, as the reference picks by backend)


def _bytes_to_tb(data: bytes, tbs: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    assert len(bits) <= tbs, (len(bits), tbs)
    tb = np.zeros(tbs, np.int32)
    tb[:len(bits)] = bits
    return tb


def _tb_to_bytes(tb_bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(tb_bits, np.uint8)).tobytes()



def _long(a: np.ndarray, dev) -> torch.Tensor:
    """A static index array as int64 on `dev`, uploaded once."""
    return device_plan(a, dev, dtype=torch.long)


def _signs(seq: np.ndarray) -> np.ndarray:
    return 1.0 - 2.0 * seq.astype(np.float32)


def _upload(x: np.ndarray, dev) -> torch.Tensor:
    """A host wave (the clean wave plus the float64 noise) rounded to
    complex64 and put on `dev`, where the reference rounds it at its upload."""
    return torch.as_tensor(np.asarray(x, np.complex64), device=dev)


def _eq_llr(rgrid, H, n0: float, sym, bins, sc, qm: int, dev):
    """Zero-forcing equalization and the plain max-log demap of the REs at
    (sym, bins) / (sym, sc), |h|^2 clamped at 1e-9, flattened to [1, N]:
    the reference's hand-written eq_llr (the fused mrc_llr kernel is not
    on this path, as in the reference)."""
    s = _long(sym, dev)
    y = rgrid[:, s, _long(bins, dev)]
    h = H[:, s, _long(sc, dev)]
    g = torch.clamp(h.abs() ** 2, min=1e-9)
    return demap_llr(y * torch.conj(h) / g, n0 / g, qm).reshape(1, -1)


class DlAir:
    """Downlink over-the-air path: complete eNB subframe -> AWGN -> blind
    UE receiver, on `device` (None: the card). Per-(subframe, alloc) host
    precompute is cached, and its device plans are uploaded once; the
    device work is grid scatters + (I)FFT + codec kernels."""

    def __init__(self, cfg: CapstoneConfig, rng: np.random.Generator,
                 device=None):
        self.cfg = cfg
        self.rng = rng
        self.device = resolve_device(device)
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        self.n0 = 10.0 ** (-cfg.snr_db / 10.0)
        self._enb_tx: dict = {}
        self._gm: dict = {}
        self._wiener: dict = {}
        self._am: dict = {}
        self._codec: dict = {}
        self._scr: dict = {}
        self._pscr: dict = {}
        self.size_1c = dci_format1c_size(cfg.n_rb)
        self.size_1a = dci_format1a_size(cfg.n_rb)

    # ------------------------------------------------------------ caches --
    def enb_tx(self, subframe: int, alloc: Alloc) -> EnbTx:
        key = (subframe, alloc)
        if key not in self._enb_tx:
            self._enb_tx[key] = EnbTx(CellConfig(
                n_rb=self.cfg.n_rb, n_id_cell=self.cfg.n_id_cell,
                n_pdcch=self.cfg.n_pdcch, subframe=subframe,
                rb_start=alloc.rb_start, n_prb=alloc.n_prb, mcs=alloc.mcs),
                self.device)
        return self._enb_tx[key]

    def codec(self, alloc: Alloc) -> DlschCodec:
        key = (alloc.mcs, alloc.n_prb)
        if key not in self._codec:
            self._codec[key] = DlschCodec(DlschConfig(
                mcs=alloc.mcs, n_rb=alloc.n_prb,
                n_pdcch_symbols=self.cfg.n_pdcch,
                n_turbo_iter=self.cfg.n_turbo_iter,
                decoder_window=self.cfg.decoder_window))
        return self._codec[key]

    def scr(self, rnti: int, ns: int, G: int) -> np.ndarray:
        key = (rnti, ns, G)
        if key not in self._scr:
            self._scr[key] = gold_sequence(
                pdsch_cinit(rnti, 0, ns, self.cfg.n_id_cell), G)
        return self._scr[key]

    def gm(self, subframe: int):
        if subframe not in self._gm:
            self._gm[subframe] = make_grid_map(
                self.cfg.n_rb, self.cfg.n_pdcch, self.cfg.n_id_cell,
                subframe)
        return self._gm[subframe]

    def wiener(self, subframe: int):
        if subframe not in self._wiener:
            self._wiener[subframe] = wiener_stack_from_reference(
                make_wiener_stack(self.gm(subframe), self.n0 / 4.0),
                self.device)
        return self._wiener[subframe]

    def am(self, subframe: int, rb_start: int, n_prb: int):
        key = (subframe, rb_start, n_prb)
        if key not in self._am:
            self._am[key] = make_grid_map(
                self.cfg.n_rb, self.cfg.n_pdcch, self.cfg.n_id_cell,
                subframe, rb_alloc=(rb_start, n_prb))
        return self._am[key]

    def pscr(self, ns: int, n_cce: int) -> np.ndarray:
        if ns not in self._pscr:
            self._pscr[ns] = pdcch_scramble_seq(
                self.cfg.n_id_cell, ns, n_cce * BITS_PER_CCE)
        return self._pscr[ns]

    # ---------------------------------------------------------------- TX --
    def transmit_clean(self, subframe: int, pdsch=None, ul_grants=()):
        """Build one DL subframe -> CLEAN time-domain wave (no noise), a
        complex64 numpy [1, samples_per_tti].

        pdsch: None or (kind, rnti, tb_bytes[, alloc]) with kind 'common'
        (DCI 1C) or 'ded' (DCI 1A); the optional 4th element overrides
        the config's static allocation — LINK ADAPTATION (the scheduler
        picks MCS from reported CQI; the UE needs no signalling beyond
        the DCI it already blind-decodes). ul_grants: [(rnti, Alloc)]
        DCI format-0 UL grants (several UEs may be granted disjoint
        PRBs in one TTI).
        The broadcast wave is shared by every listening UE; each adds its
        own receiver noise (ue_demod) — the oaisim full-PHY semantic of
        coupling all eNB x UE pairs at sample level (channel_sim.c:81).
        """
        cfg, dev = self.cfg, self.device
        alloc = (cfg.common if pdsch and pdsch[0] == "common" else cfg.ded)
        if pdsch is not None and len(pdsch) > 3 and pdsch[3] is not None:
            alloc = pdsch[3]
        enb = self.enb_tx(subframe, alloc)
        ns = 2 * subframe
        n_cce = enb.crm.n_cce
        dcis = []
        used: set = set()
        if pdsch is not None:
            kind, rnti, data = pdsch[:3]
            if kind == "common":
                payload = pack_dci_format1c(cfg.n_rb, alloc.rb_start,
                                            alloc.n_prb, mcs=alloc.mcs)
                cand = common_search_candidates(n_cce)[0]   # L=4 @ CCE 0
            else:
                payload = pack_dci_format1a(
                    cfg.n_rb, rb_start=alloc.rb_start, n_prb=alloc.n_prb,
                    mcs=alloc.mcs, harq_pid=0, ndi=1, rv=0)
                cand = ue_search_candidates(n_cce, rnti, subframe)[0]
            dcis.append((payload, rnti, cand.L, cand.cce_offset))
            used.update(range(cand.cce_offset, cand.cce_offset + cand.L))
        for g_rnti, g in ul_grants:
            payload = pack_dci_format0(cfg.n_rb, g.rb_start, g.n_prb,
                                       g.mcs, ndi=1)
            cand = next(c for c in
                        ue_search_candidates(n_cce, g_rnti, subframe)
                        if not used & set(range(c.cce_offset,
                                                c.cce_offset + c.L)))
            used.update(range(cand.cce_offset, cand.cce_offset + cand.L))
            dcis.append((payload, g_rnti, cand.L, cand.cce_offset))
        enb.set_dcis(dcis)

        codec = self.codec(alloc)
        if pdsch is not None:
            tb = _bytes_to_tb(pdsch[2], codec.cfg.tbs)
            e = codec.encode(torch.as_tensor(tb[None], device=dev))
            e = scramble_bits(e, self.scr(pdsch[1], ns, codec.cfg.G))
        else:
            e = torch.zeros((1, codec.cfg.G), dtype=torch.int32, device=dev)
        syms = map_symbols(e, codec.cfg.Qm).to(torch.complex64)
        grid = enb.data_subframe(syms)
        return ofdm.ofdm_modulate(grid, self.fp).cpu().numpy()

    def ue_demod(self, t: np.ndarray, rng=None, n0: float | None = None):
        """One UE's receiver front end: its own AWGN (drawn and added on
        the host, in float64) + OFDM demod on the device.
        `n0` overrides the cell-wide noise floor (per-UE link budgets in
        the multi-UE capstone)."""
        rng = self.rng if rng is None else rng
        n0 = self.n0 if n0 is None else n0
        noise = (rng.standard_normal(t.shape)
                 + 1j * rng.standard_normal(t.shape)) \
            * np.sqrt(n0 / 2)
        return ofdm.ofdm_demodulate(_upload(t + noise, self.device), self.fp)

    def transmit(self, subframe: int, pdsch=None, ul_grant_rnti=None):
        """Single-UE path: clean wave + this sim's noise in one call."""
        grants = [(ul_grant_rnti, self.cfg.ul)] if ul_grant_rnti is not \
            None else ()
        return self.ue_demod(self.transmit_clean(subframe, pdsch, grants))

    # ---------------------------------------------------------------- RX --
    def receive(self, rgrid, subframe: int, common_rntis: list,
                crnti: int | None):
        """Blind UE receiver for one subframe.

        common_rntis: RA/SI/P-RNTIs to try in the common search space
        (DCI 1C). crnti: UE-specific search space (1A/format-0 class).
        Returns dict(pdsch=(rnti, bytes)|None, ul_grant=dict|None).
        """
        cfg, dev = self.cfg, self.device
        ns = 2 * subframe
        gm = self.gm(subframe)
        H = estimate_channel(rgrid, gm, self.wiener(subframe),
                             time_avg=True)
        crm = self.enb_tx(subframe, cfg.common).crm   # control geometry

        def eq_llr(sym_idx, bin_idx, sc_idx, qm):
            return _eq_llr(rgrid, H, self.n0, sym_idx, bin_idx, sc_idx, qm,
                           dev)

        sgn = device_plan(self.pscr(ns, crm.n_cce), dev, _signs)
        llr_pdcch = eq_llr(crm.pdcch_sym, crm.pdcch_bin,
                           crm.pdcch_sc, 2) * sgn

        out = dict(pdsch=None, ul_grant=None)

        def decode_pdsch(alloc: Alloc, rnti: int) -> bytes | None:
            codec = self.codec(alloc)
            am = self.am(subframe, alloc.rb_start, alloc.n_prb)
            llr = eq_llr(am.data_sym, am.data_bin, am.data_sc,
                         codec.cfg.Qm)
            llr = unscramble_llrs(llr, self.scr(rnti, ns, codec.cfg.G))
            tb, ok, _ = codec.decode(llr)
            if not bool(ok[0]):
                LOG_W("PHY", "PDSCH CRC fail (rnti=0x%04x sf=%d)", rnti,
                      subframe)
                return None
            return _tb_to_bytes(tb[0].cpu().numpy())

        commons = common_search_candidates(crm.n_cce)
        for rnti in common_rntis:
            found, payload, _ = dci_blind_decode(
                llr_pdcch, self.size_1c, rnti, commons)
            if bool(found[0]):
                a = unpack_dci_format1c(payload[0].cpu().numpy(), cfg.n_rb)
                data = decode_pdsch(Alloc(a["rb_start"], a["n_prb"],
                                          a["mcs"]), rnti)
                if data is not None:
                    out["pdsch"] = (rnti, data)
                break
        if crnti is not None:
            cands = ue_search_candidates(crm.n_cce, crnti, subframe)
            found, payload, _ = dci_blind_decode(
                llr_pdcch, self.size_1a, crnti, cands)
            if bool(found[0]):
                bits = payload[0].cpu().numpy()
                g0 = unpack_dci_format0(bits, cfg.n_rb)
                if g0["is_format0"]:
                    out["ul_grant"] = g0
                else:
                    a = unpack_dci_format1a(bits, cfg.n_rb)
                    data = decode_pdsch(Alloc(a["rb_start"], a["n_prb"],
                                              a["mcs"]), crnti)
                    if data is not None:
                        out["pdsch"] = (crnti, data)
        return out


class UlAir:
    """Uplink over-the-air path: UE SC-FDMA subframe -> AWGN -> eNB
    receiver on `device` (None: the card), cached per (grant, rnti,
    subframe)."""

    def __init__(self, cfg: CapstoneConfig, rng: np.random.Generator,
                 device=None):
        self.cfg = cfg
        self.rng = rng
        self.device = resolve_device(device)
        self.n0 = 10.0 ** (-cfg.snr_db / 10.0)
        self._pairs: dict = {}

    def pair(self, alloc: Alloc, rnti: int, subframe: int):
        key = (alloc, rnti, subframe)
        if key not in self._pairs:
            tx = UeTx(UeUlConfig(
                n_rb=self.cfg.n_rb, mcs=alloc.mcs, n_rb_alloc=alloc.n_prb,
                rb_offset=alloc.rb_start, rnti=rnti,
                n_id_cell=self.cfg.n_id_cell, subframe=subframe,
                n_turbo_iter=self.cfg.n_turbo_iter,
                decoder_window=self.cfg.decoder_window), self.device)
            self._pairs[key] = (tx, EnbRx(tx))
        return self._pairs[key]

    def tbs_bytes(self, alloc: Alloc, subframe: int = 0) -> int:
        tx, _ = self.pair(alloc, 0xFFF1, subframe)
        return tx.codec.cfg.tbs // 8

    def run(self, alloc: Alloc, rnti: int, subframe: int,
            pdu: bytes) -> bytes | None:
        """MAC PDU bytes -> PUSCH -> eNB decode -> bytes (None on CRC
        fail)."""
        return self.run_multi([(alloc, rnti, subframe, pdu)])[0]

    def run_multi(self, entries: list) -> list:
        """Several UEs' PUSCH subframes in ONE TTI: the time-domain waves
        SUM in the air (disjoint PRBs -> FDM; identical allocations -> a
        real Msg3 collision whose sum fails CRC), then the eNB runs one
        receiver per granted allocation on the composite signal
        (oaisim do_UL_sig coupling, channel_sim.c:398). The sum and the
        noise are formed on the host, as in the reference.

        entries: [(Alloc, rnti, subframe, pdu_bytes)] -> [bytes | None].
        """
        dev = self.device
        waves = []
        for alloc, rnti, subframe, pdu in entries:
            tx, _ = self.pair(alloc, rnti, subframe)
            tb = _bytes_to_tb(pdu, tx.codec.cfg.tbs)
            waves.append(tx.pusch_subframe(
                torch.as_tensor(tb[None], device=dev)).cpu().numpy())
        total = np.sum(waves, axis=0)
        total = total + (self.rng.standard_normal(total.shape)
                         + 1j * self.rng.standard_normal(total.shape)) \
            * np.sqrt(self.n0 / 2)
        total = _upload(total, dev)
        out = []
        for alloc, rnti, subframe, pdu in entries:
            _, rx = self.pair(alloc, rnti, subframe)
            tb_hat, ok, _ = rx.receive_pusch(total, self.n0)
            if not bool(ok[0]):
                LOG_W("PHY", "PUSCH CRC fail (rnti=0x%04x sf=%d)", rnti,
                      subframe)
                out.append(None)
            else:
                out.append(_tb_to_bytes(tb_hat[0].cpu().numpy()))
        return out


def _srb_pdcp(direction: int) -> PdcpEntity:
    """SRB1 PDCP entity (36.323 SRB profile: 5-bit SN, MAC-I trailer,
    no ciphering). direction = own TX sense (0 UL / 1 DL)."""
    return PdcpEntity(PdcpConfig(sn_bits=5, bearer=1, integrity=True,
                                 direction=direction))


@dataclass
class UeStack:
    """UE-side protocol state above the PHY."""
    rrc: RrcUe
    nas: UeNas
    ra: RaProcedure | None = None
    srb1: RlcAm = field(default_factory=lambda: RlcAm(poll_every=2))
    drb: RlcUm | None = None
    pdcp_ul: PdcpEntity | None = None
    pdcp_dl: PdcpEntity | None = None
    srb_pdcp_tx: PdcpEntity = field(
        default_factory=lambda: _srb_pdcp(direction=0))
    srb_pdcp_rx: PdcpEntity = field(
        default_factory=lambda: _srb_pdcp(direction=0))
    srb1_txq: list = field(default_factory=list)    # PDCP PDUs for SRB1
    status_txq: list = field(default_factory=list)  # RLC status to send
    msg3: bytes | None = None
    crnti: int | None = None
    delivered_ip: list = field(default_factory=list)
    ra_tti: int = 0                 # when the preamble went out
    contention_losses: int = 0
    meas_cqi: int | None = None     # wideband CQI measured from the grid

    def queue_srb1(self, rrc_sdu: bytes) -> None:
        """RRC SDU -> SRB1 PDCP PDU -> RLC-AM tx queue."""
        self.srb1_txq.append(self.srb_pdcp_tx.data_req(rrc_sdu))

    @property
    def sr_pending(self) -> bool:
        """Stands in for PUCCH SR (format 1 detection: sim/pucchsim.py)."""
        return bool(self.msg3 is not None or self.srb1_txq
                    or self.status_txq or self.srb1.has_data()
                    or (self.drb is not None and self.drb._txq))


class FullStackSim:
    """The capstone: one eNB + one UE + EPC, every PDU over the PHY, on
    `device` (None: the card)."""

    def __init__(self, cfg: CapstoneConfig = CapstoneConfig(),
                 artifact_dir: str | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(cfg.seed)
        self.dl = DlAir(cfg, self.rng, self.device)
        self.ul = UlAir(cfg, self.rng, self.device)
        self.msc = Msc()
        self.pcap = None
        self._artifact_dir = artifact_dir
        if artifact_dir is not None:
            import os
            os.makedirs(artifact_dir, exist_ok=True)
            self.pcap = PcapWriter(f"{artifact_dir}/capstone.pcap")

        # EPC + eNB control plane
        hss = Hss()
        hss.provision(cfg.imsi, cfg.k)
        self.sgw = SgwPgw()
        self.mme = Mme(hss, self.sgw)
        self.enb_rrc = RrcEnb(sib1=Sib1(), sib2=Sib2(
            prach_root_sequence=cfg.prach_root,
            zero_correlation_zone=NCS_UNRESTRICTED.index(cfg.prach_ncs),
            default_paging_cycle=cfg.paging_cycle_idx))
        self.enb_app = EnbApp(self.mme, self.sgw, msc=self.msc,
                              pcap=self.pcap)
        # eNB per-UE L2 (single UE)
        self.enb_srb1 = RlcAm(poll_every=2)
        self.enb_srb_pdcp_tx = _srb_pdcp(direction=1)
        self.enb_srb_pdcp_rx = _srb_pdcp(direction=1)
        self._smc_sent = False
        self.enb_drb: RlcUm | None = None
        self.enb_pdcp_dl: PdcpEntity | None = None
        self.enb_pdcp_ul: PdcpEntity | None = None
        self.enb_srb1_txq: list = []
        self.enb_status_txq: list = []
        self.enb_drb_txq: list = []      # PDCP PDUs for the DRB
        self._msg4: tuple | None = None  # (t_crnti, cr_ce, setup_bytes)
        self._msg3_sdu: bytes | None = None
        self._rar_due: list = []         # (tti, Rar, ra_rnti)
        self._ul_due: dict = {}          # tti -> (rnti, Alloc, kind)
        self._grant_outstanding = False
        self._reconf_sent = False
        self._crnti: int | None = None

        # UE
        self.ue = UeStack(rrc=RrcUe(seed=cfg.seed),
                          nas=UeNas(cfg.imsi, cfg.k))
        self.ue_echo_sent = False
        self._big_nas_sent = False
        self.trace: list = []
        self.tti = 0
        self.phy_runs = dict(dl=0, ul=0, prach=0)
        # paging (36.304): idle DRX occasions from SIB2's pcch-Config
        from ..rrc.paging import PagingConfig, ue_paging_id
        self.pcfg = PagingConfig.from_sib2(self.enb_rrc.sib2)
        self.ue_pid = ue_paging_id(cfg.imsi)
        self.ue_paged = not cfg.mt_attach   # MO attach: RA immediately
        self._page_due: int | None = None
        self.po_monitored = 0

    # ------------------------------------------------------------- helpers --
    def _ev(self, what: str):
        self.trace.append((self.tti, what))
        LOG_I("SIM", "t=%d %s", self.tti, what)

    def _mrec(self, src, dst, label):
        self.msc.tick(self.tti)
        self.msc.record(src, dst, label)

    def _pcap_mac(self, pdu: bytes, direction: int, rnti: int):
        if self.pcap is not None:
            self.pcap.write(pdu, tti=self.tti, direction=direction,
                            kind=KIND_MAC, rnti=rnti)

    def _enb_queue_srb1(self, rrc_sdu: bytes) -> None:
        """eNB RRC SDU -> SRB1 PDCP PDU -> RLC-AM tx queue."""
        self.enb_srb1_txq.append(self.enb_srb_pdcp_tx.data_req(rrc_sdu))

    # -------------------------------------------------------------- camp --
    def cold_sync(self) -> bool:
        """PSS/SSS/PBCH from a noisy timing-offset capture
        (initial_sync.c:274 hypothesis loop, here the FDD-NCP branch)."""
        cfg, fp = self.cfg, self.dl.fp
        enb = self.dl.enb_tx(0, cfg.common)
        grid0 = enb.sync_subframe_host(sfn=0)
        wave = ofdm.ofdm_modulate_host(grid0[None], fp)[0]
        search = CellSearch(fp)
        L = search.capture_len
        off = int(self.rng.integers(0, L - fp.samples_per_tti - fp.n_fft))
        cap = np.zeros(L, np.complex64)
        cap[off:off + len(wave)] = wave
        cap += ((self.rng.standard_normal(L)
                 + 1j * self.rng.standard_normal(L))
                * np.sqrt(self.dl.n0 / 2)).astype(np.complex64)
        dev = self.device
        res = search.search(torch.as_tensor(cap[None], device=dev))
        nid2 = int(res["nid2"][0])
        nid1 = int(res["nid1"][0])
        nid = 3 * nid1 + nid2
        if nid != cfg.n_id_cell:
            return False
        # PBCH MIB from the frame-aligned capture
        rgrid = ofdm.ofdm_demodulate(torch.as_tensor(
            cap[None, off:off + fp.samples_per_tti], device=dev), fp)
        gm0 = self.dl.gm(0)
        H = estimate_channel(rgrid, gm0, self.dl.wiener(0), time_avg=True)
        pm = make_pbch_map(cfg.n_rb, nid)
        llr = _eq_llr(rgrid, H, self.dl.n0, pm.sym, pm.bins, pm.sc, 2, dev)
        ok, bits, _, _ = pbch_blind_decode(llr, nid)
        if not bool(ok[0]):
            return False
        mib = unpack_mib(bits[0].cpu().numpy())
        self.ue.rrc.on_cell_found(nid, Mib(sfn_msb8=mib["sfn_msb8"]))
        self._ev(f"UE camped: PCI={nid} MIB n_rb={mib['n_rb']}")
        self._mrec("UE", "eNB", "PSS/SSS+PBCH sync")
        return True

    # --------------------------------------------------------- eNB DL TTI --
    def _enb_dl_decision(self, sfn: int, sf: int):
        """-> (pdsch | None, ul_grant_rnti | None) for this TTI."""
        si = self.enb_rrc.bcch_schedule(sfn, sf)
        if si is not None:
            return ("common", SI_RNTI, si), None
        if self._page_due == self.tti:
            self._page_due = None
            from ..rrc.messages import Paging
            pg = Paging(ue_identity=self.cfg.imsi & ((1 << 40) - 1))
            self._ev(f"eNB transmits Paging at PO (sfn={sfn} sf={sf})")
            self._mrec("eNB", "UE", "Paging (P-RNTI, DCI 1C)")
            return ("common", P_RNTI, pg.pack()), None
        for i, (due, rar, rarnti) in enumerate(self._rar_due):
            if self.tti >= due:
                self._rar_due.pop(i)
                return ("common", rarnti, bytes(pack_rar(rar))), None
        if self._msg4 is not None:
            t_crnti, cr, setup = self._msg4
            self._msg4 = None
            tbs = self.dl.codec(self.cfg.ded).cfg.tbs // 8
            pdu = pack_mac_pdu([(LCID_CONTENTION_RESOLUTION, cr),
                                (LCID_CCCH, setup)], tbs)
            self._pcap_mac(pdu, DIR_DL, t_crnti)
            return ("ded", t_crnti, pdu), None
        # DCCH / DRB data for the connected UE
        if self._crnti is not None and (
                self.enb_srb1_txq or self.enb_status_txq
                or self.enb_srb1.has_data() or self.enb_drb_txq):
            pdu = self._build_dl_mac_pdu()
            if pdu is not None:
                self._pcap_mac(pdu, DIR_DL, self._crnti)
                return ("ded", self._crnti, pdu), None
        # UL grant when the UE signals SR and none outstanding
        if (self._crnti is not None and self.ue.sr_pending
                and not self._grant_outstanding):
            return None, self._crnti
        return None, None

    def _build_dl_mac_pdu(self) -> bytes | None:
        tbs = self.dl.codec(self.cfg.ded).cfg.tbs // 8
        subs = []
        budget = tbs - 8          # head room for subheaders
        for st in self.enb_status_txq[:]:
            raw = pack_am_status(st)
            if len(raw) <= budget:
                subs.append((LCID_SRB1, raw))
                budget -= len(raw) + 2
                self.enb_status_txq.remove(st)
        # SRB1: size-fitted AM PDUs — large NAS/RRC messages segment
        # across grants, NACKed PDUs re-segment to the current grant
        # (rlc_am_segment.c / rlc_am_resegment.c parity)
        for sdu in self.enb_srb1_txq:
            self.enb_srb1.tx_enqueue(sdu)
        self.enb_srb1_txq.clear()
        while budget > 16 and self.enb_srb1.has_data():
            pdu = self.enb_srb1.tx_pdu(size=budget - 12)
            if pdu is None:
                break
            raw = pack_am(pdu)
            assert len(raw) <= budget, (len(raw), budget)
            subs.append((LCID_SRB1, raw))
            budget -= len(raw) + 2
        if self.enb_drb is not None:
            for p in self.enb_drb_txq:
                self.enb_drb.tx_enqueue(p)
            self.enb_drb_txq.clear()
            while budget > 6 and self.enb_drb._txq:
                um = self.enb_drb.tx_pdu(budget - 6)
                if um is None:
                    break
                raw = pack_um(um)
                subs.append((LCID_DRB, raw))
                budget -= len(raw) + 2
        return pack_mac_pdu(subs, tbs) if subs else None

    # ---------------------------------------------------------- UE DL RX --
    def _ue_dl_process(self, res: dict, sfn: int, sf: int):
        ue = self.ue
        if res["ul_grant"] is not None:
            g = res["ul_grant"]
            due = self.tti + 4                      # k+4 PUSCH timing
            self._ul_due[due] = (ue.crnti, Alloc(g["rb_start"], g["n_prb"],
                                                 g["mcs"]), "data")
            self._grant_outstanding = True
            LOG_D("MAC", "UE got UL grant for t=%d", due)
        if res["pdsch"] is None:
            return
        rnti, data = res["pdsch"]
        if rnti == SI_RNTI:
            ue.rrc.on_bcch(data)
            self._ev(f"UE received SI ({type(decode_message(data)).__name__})")
            self._mrec("eNB", "UE", "BCCH SI on PDSCH (DCI 1C)")
        elif rnti == P_RNTI:
            from ..rrc.messages import Paging
            pg = decode_message(data)
            if isinstance(pg, Paging) and \
                    pg.ue_identity == self.cfg.imsi & ((1 << 40) - 1):
                self.ue_paged = True
                self._ev("UE paged (MT) at its paging occasion -> RA")
                self._mrec("UE", "eNB", "paging-triggered access")
        elif ue.ra is not None and rnti == self._expected_ra_rnti():
            rar = unpack_rar(np.frombuffer(data[:7], np.uint8))
            if ue.ra.on_rar(rar):
                self._ev(f"UE matched RAR (rapid={rar.rapid} "
                         f"ta={rar.timing_advance} tc={rar.t_crnti:#x})")
                self._mrec("eNB", "UE", "RAR (RA-RNTI, DCI 1C)")
                ue.crnti = rar.t_crnti
                # grant: Msg3 at +6 TTIs on the cfg.msg3 allocation
                self._ul_due[self.tti + 6] = (rar.t_crnti, self.cfg.msg3,
                                              "msg3")
                ue.msg3 = ue.rrc.connection_request()
        elif ue.crnti is not None and rnti == ue.crnti:
            self._ue_mac_demux(data)

    def _ue_mac_demux(self, pdu: bytes):
        ue = self.ue
        self._pcap_mac(pdu, DIR_DL, ue.crnti or 0)
        for lcid, payload in unpack_mac_pdu(pdu):
            if lcid == LCID_CONTENTION_RESOLUTION:
                won = contention_resolution_matches(payload, ue.msg3 or b"")
                ue.ra.on_contention_resolution(won)
                if won:
                    self._ev("UE won contention resolution")
                    ue.msg3 = None
            elif lcid == LCID_CCCH:
                resp = ue.rrc.on_ccch(ue.crnti, payload)
                self._mrec("eNB", "UE", "RRCConnectionSetup (Msg4, CCCH)")
                if resp is not None:
                    # attach the initial NAS (dedicatedInfoNAS ride)
                    sc = decode_message(resp)
                    sc.dedicated_info_nas = ue.nas.attach_request()
                    ue.queue_srb1(sc.pack())
                    self._ev("UE queued SetupComplete + NAS AttachRequest")
            elif lcid == LCID_SRB1:
                rlc = unpack_am(payload)
                if isinstance(rlc, StatusPdu):
                    ue.srb1.on_status(rlc)
                    continue
                n0 = len(ue.srb1.delivered)
                st = ue.srb1.rx_pdu(rlc)
                if st is not None:
                    ue.status_txq.append(st)
                for pdcp_pdu in ue.srb1.delivered[n0:]:
                    sdu = ue.srb_pdcp_rx.data_ind(pdcp_pdu)
                    if sdu is None:
                        LOG_W("PDCP", "UE SRB1 PDU discarded "
                              "(integrity/duplicate)")
                        continue
                    self._ue_dcch(sdu)
            elif lcid == LCID_DRB and ue.drb is not None:
                n0 = len(ue.drb.delivered)
                ue.drb.rx_pdu(unpack_um(payload))
                for sdu in ue.drb.delivered[n0:]:
                    pkt = ue.pdcp_dl.data_ind(sdu)
                    if pkt is not None:
                        ue.delivered_ip.append(pkt)
                        self._ev(f"UE received IP packet ({len(pkt)}B) "
                                 "over the DRB")
                        self._mrec("eNB", "UE", "IP packet (DRB, PDSCH)")

    def _ue_dcch(self, sdu: bytes):
        ue = self.ue
        msg = decode_message(sdu)
        if isinstance(msg, SecurityModeCommand):
            # The SMC arrived with a valid MAC-I (PDCP flipped rx to "on");
            # activate TX protection and confirm (36.331 §5.3.4.3).
            from ..epc.security import derive_k_enb
            k_int = derive_k_rrc_int(derive_k_enb(ue.nas.kasme))
            ue.srb_pdcp_tx.activate_tx(k_int)
            ue.queue_srb1(SecurityModeComplete().pack())
            self._ev("UE AS security activated (SRB1 MAC-I both ways)")
            self._mrec("UE", "eNB", "SecurityModeComplete")
            return
        if isinstance(msg, DlInformationTransfer):
            self._mrec("eNB", "UE", "DLInformationTransfer(NAS)")
            resp = ue.nas.handle_downlink(msg.dedicated_info_nas)
            self._ev(f"UE NAS handled DL ({ue.nas.state.name})")
            if ue.nas.kasme and ue.srb_pdcp_rx._rx_state == "off":
                # KASME in place after authentication: pre-derive the AS
                # integrity key so the upcoming protected SMC verifies
                from ..epc.security import derive_k_enb
                ue.srb_pdcp_rx.arm_rx(
                    derive_k_rrc_int(derive_k_enb(ue.nas.kasme)))
            if resp is not None:
                ue.queue_srb1(UlInformationTransfer(
                    dedicated_info_nas=resp).pack())
        elif isinstance(msg, RrcConnectionReconfiguration):
            resp = ue.rrc.on_dcch(sdu)
            self._mrec("eNB", "UE", "RRCConnectionReconfiguration(DRB)")
            if msg.drb_add and ue.drb is None:
                ue.drb = RlcUm()
                ue.pdcp_ul = PdcpEntity(PdcpConfig(bearer=msg.drb_identity,
                                                   ciphering="xor"))
                ue.pdcp_dl = PdcpEntity(PdcpConfig(bearer=msg.drb_identity,
                                                   ciphering="xor"))
                self._ev("UE DRB established (RLC-UM + PDCP)")
            if resp is not None:
                ue.queue_srb1(resp)
        else:
            resp = ue.rrc.on_dcch(sdu)
            if resp is not None:
                ue.queue_srb1(resp)

    def _expected_ra_rnti(self) -> int:
        return ra_rnti(self.cfg.prach_sf)

    # ------------------------------------------------------------ UL TTI --
    def _ue_build_ul_pdu(self, kind: str, tbs: int) -> bytes:
        ue = self.ue
        if kind == "msg3":
            pdu = pack_mac_pdu([(LCID_CCCH, ue.msg3)], tbs)
            self._pcap_mac(pdu, DIR_UL, ue.crnti or 0)
            self._mrec("UE", "eNB", "Msg3 RRCConnectionRequest (CCCH/PUSCH)")
            return pdu
        subs = []
        pending = sum(len(s) for s in ue.srb1_txq) + \
            sum(len(s) for s in ue.srb1._txq) + \
            (sum(len(s) for s in ue.drb._txq) if ue.drb else 0)
        subs.append((LCID_SHORT_BSR, pack_short_bsr(0, pending)))
        budget = tbs - 8
        for st in ue.status_txq[:]:
            raw = pack_am_status(st)
            if len(raw) <= budget:
                subs.append((LCID_SRB1, raw))
                budget -= len(raw) + 2
                ue.status_txq.remove(st)
        for sdu in ue.srb1_txq:
            ue.srb1.tx_enqueue(sdu)
        ue.srb1_txq.clear()
        while budget > 16 and ue.srb1.has_data():
            pdu = ue.srb1.tx_pdu(size=budget - 12)
            if pdu is None:
                break
            raw = pack_am(pdu)
            assert len(raw) <= budget, (len(raw), budget)
            subs.append((LCID_SRB1, raw))
            budget -= len(raw) + 2
        if ue.drb is not None:
            while budget > 6 and ue.drb._txq:
                um = ue.drb.tx_pdu(budget - 6)
                if um is None:
                    break
                raw = pack_um(um)
                subs.append((LCID_DRB, raw))
                budget -= len(raw) + 2
        pdu = pack_mac_pdu(subs, tbs)
        self._pcap_mac(pdu, DIR_UL, ue.crnti or 0)
        return pdu

    def _enb_ul_process(self, data: bytes, rnti: int, kind: str):
        if kind == "msg3":
            subs = unpack_mac_pdu(data)
            assert subs and subs[0][0] == LCID_CCCH
            msg3_sdu = subs[0][1]
            # the RAR promised this T-CRNTI; RrcEnb allocates the C-RNTI
            crnti, setup = self.enb_rrc.handle_ccch(msg3_sdu)
            assert crnti == rnti, (crnti, rnti)   # peeked at RAR time
            self._crnti = crnti
            self._msg3_sdu = msg3_sdu
            self._msg4 = (crnti, pack_contention_resolution(msg3_sdu),
                          setup)
            self._ev(f"eNB Msg3 -> C-RNTI {crnti:#x}, Msg4 queued")
            self._mrec("UE", "eNB", "RRCConnectionRequest")
            return
        for lcid, payload in unpack_mac_pdu(data):
            if lcid == LCID_SHORT_BSR:
                continue                      # drives the SR flag already
            if lcid == LCID_SRB1:
                rlc = unpack_am(payload)
                if isinstance(rlc, StatusPdu):
                    self.enb_srb1.on_status(rlc)
                    continue
                n0 = len(self.enb_srb1.delivered)
                st = self.enb_srb1.rx_pdu(rlc)
                if st is not None:
                    self.enb_status_txq.append(st)
                for pdcp_pdu in self.enb_srb1.delivered[n0:]:
                    sdu = self.enb_srb_pdcp_rx.data_ind(pdcp_pdu)
                    if sdu is None:
                        LOG_W("PDCP", "eNB SRB1 PDU discarded "
                              "(integrity/duplicate)")
                        continue
                    self._enb_dcch(sdu)
            elif lcid == LCID_DRB and self.enb_drb is not None:
                n0 = len(self.enb_drb.delivered)
                self.enb_drb.rx_pdu(unpack_um(payload))
                for sdu in self.enb_drb.delivered[n0:]:
                    pkt = self.enb_pdcp_ul.data_ind(sdu)
                    if pkt is not None:
                        self._ev(f"eNB -> GTP-U uplink IP ({len(pkt)}B)")
                        self.enb_app.uplink_user(self._crnti, pkt)

    def _enb_dcch(self, sdu: bytes):
        msg = decode_message(sdu)
        crnti = self._crnti
        if isinstance(msg, RrcConnectionSetupComplete):
            self.enb_rrc.handle_dcch(crnti, sdu)
            self._mrec("UE", "eNB", "RRCConnectionSetupComplete")
            self._ev("eNB RRC: UE connected; forwarding initial NAS")
            self.enb_app.initial_ue_message(crnti,
                                            msg.dedicated_info_nas)
        elif isinstance(msg, UlInformationTransfer):
            self._mrec("UE", "eNB", "ULInformationTransfer(NAS)")
            self.enb_app.uplink_nas(crnti, msg.dedicated_info_nas)
        else:
            resp = self.enb_rrc.handle_dcch(crnti, sdu)
            if resp is not None:
                self._enb_queue_srb1(resp)
        # AS security: once InitialContextSetup delivered K_eNB, the SMC
        # goes out FIRST (before the piggybacked NAS / reconfiguration),
        # protected with the new K_RRCint — rrc_eNB SMC before
        # defaultRRCConnectionReconfiguration (33.401 §7.2.4.5)
        ctx = self.enb_app.by_crnti.get(crnti)
        if (ctx and ctx.security_key and not self._smc_sent
                and self.enb_rrc.ues[crnti].state == UeState.CONNECTED):
            self._smc_sent = True
            k_int = derive_k_rrc_int(ctx.security_key)
            smc = self.enb_rrc.security_mode_command(crnti)
            self.enb_srb_pdcp_tx.activate_tx(k_int)
            self.enb_srb_pdcp_rx.arm_rx(k_int)
            self._enb_queue_srb1(smc)
            self._ev("eNB queued AS SecurityModeCommand (SRB1 MAC-I on)")
            self._mrec("eNB", "UE", "SecurityModeCommand (SRB1, MAC-I)")
        # drain NAS toward the UE + set up the DRB once the bearer exists
        for nas in (self.enb_app.poll_nas(crnti) if ctx else []):
            self._enb_queue_srb1(DlInformationTransfer(
                dedicated_info_nas=nas).pack())
        if (ctx and ctx.sgw_teid_ul and not self._reconf_sent
                and self.enb_rrc.ues[crnti].state == UeState.CONNECTED):
            self._reconf_sent = True
            self._enb_queue_srb1(self.enb_rrc.reconfigure(
                crnti, drb_add=True))
            self.enb_drb = RlcUm()
            self.enb_pdcp_dl = PdcpEntity(PdcpConfig(bearer=1,
                                                     ciphering="xor"))
            self.enb_pdcp_ul = PdcpEntity(PdcpConfig(bearer=1,
                                                     ciphering="xor"))
            self._ev("eNB: default bearer up, DRB reconfiguration queued")

    # ------------------------------------------------------------- PRACH --
    def _prach_tti(self):
        cfg, ue = self.cfg, self.ue
        if ue.rrc.state != RrcState.IDLE_READY or ue.ra is not None:
            pass
        if (self.ue_paged and ue.rrc.state == RrcState.IDLE_READY
                and (ue.ra is None or ue.ra.state == "idle")):
            v = int(self.rng.integers(0, n_preambles(cfg.prach_ncs)))
            ue.ra = RaProcedure(preamble=v)
            ue.ra.send_preamble()
            self.phy_runs["prach"] += 1
            # Through the REAL front end (VERDICT r3 item 5): format-0
            # burst into the sample stream at fs = n_fft*15 kHz
            # (generate_prach prach.c:598), propagation delay as an
            # integer SAMPLE shift, AWGN at sample level, then eNB
            # detection from samples (rx_prach :1061).
            n_fft = self.dl.fp.n_fft
            N = prach_samples_per_seq(n_fft, 0)
            dev = self.device
            xf = torch.as_tensor(
                preamble_freq(cfg.prach_root, v, cfg.prach_ncs)[None],
                device=dev)
            burst = prach_time_generate(xf, n_fft, 0, n_ra_prb=0,
                                        n_rb_ul=cfg.n_rb)
            delay_samples = int(round(cfg.prach_delay * N / N_ZC))
            burst = torch.roll(burst, delay_samples, dims=-1)
            noise = (self.rng.standard_normal(tuple(burst.shape))
                     + 1j * self.rng.standard_normal(tuple(burst.shape))) \
                * np.sqrt(self.dl.n0 / 2)
            # the burst is on the device: the noise is rounded to complex64
            # before the sum, as in the reference
            energy, delay, det = prach_time_detect(
                burst + _upload(noise, dev), n_fft, 0, 0, cfg.n_rb,
                cfg.prach_root, cfg.prach_ncs)
            det = det[0].cpu().numpy()
            delay = delay.cpu().numpy()
            self._ev(f"UE sent PRACH preamble {v} (time-domain, "
                     f"{burst.shape[-1]} samples)")
            self._mrec("UE", "eNB", f"PRACH preamble {v}")
            for rapid in np.nonzero(det)[0]:
                ta = timing_advance_from_delay(
                    float(delay[0, rapid]) * self.dl.fp.n_fft / N_ZC,
                    self.dl.fp.n_fft)
                # peek the C-RNTI RrcEnb will allocate (T-CRNTI == C-RNTI
                # after contention resolution, 36.321 §5.1.5)
                t_crnti = self.enb_rrc._next_crnti
                g = self.cfg.msg3
                grant = (g.rb_start << 15) | (g.n_prb << 10) | (g.mcs << 5)
                rar = Rar(rapid=int(rapid), timing_advance=ta,
                          ul_grant=grant, t_crnti=t_crnti)
                self._rar_due.append((self.tti + 3, rar,
                                      self._expected_ra_rnti()))
                self._ev(f"eNB detected preamble {int(rapid)} "
                         f"(TA={ta}), RAR queued")

    def _mme_registered(self) -> bool:
        from ..epc.mme import EmmState
        return any(c.state == EmmState.REGISTERED
                   for c in self.mme.ues.values())

    # --------------------------------------------------------------- run --
    def run(self) -> dict:
        cfg = self.cfg
        assert self.cold_sync(), "cell search failed"
        ip_payload = b"capstone-ping " + bytes(range(34))
        from ..rrc.paging import is_paging_occasion, next_paging_occasion
        while self.tti < cfg.max_ttis:
            sfn, sf = self.tti // 10, self.tti % 10
            # MME-originated page (MT attach) -> eNB queues it for the PO
            if cfg.mt_attach and self.tti == cfg.page_at_tti:
                self.enb_app.handle_mme_initiated(self.mme.page(cfg.imsi))
                self._ev("MME pages the idle UE (S1AP Paging)")
            if self.enb_app.pending_pages and self._page_due is None:
                pid = self.enb_app.pending_pages.pop(0)
                self._page_due = next_paging_occasion(self.pcfg, pid % 1024,
                                                      self.tti + 1)
                self._ev(f"eNB schedules page for PO at t={self._page_due}")
            # eNB DL
            pdsch, grant_rnti = self._enb_dl_decision(sfn, sf)
            if pdsch is not None or grant_rnti is not None:
                self.phy_runs["dl"] += 1
                rgrid = self.dl.transmit(sf, pdsch, grant_rnti)
                commons = [SI_RNTI]
                if not self.ue_paged and is_paging_occasion(
                        self.pcfg, self.ue_pid, sfn, sf):
                    commons.append(P_RNTI)      # idle DRX: PO-only monitor
                    self.po_monitored += 1
                if self.ue.ra is not None and \
                        self.ue.ra.state == "preamble_sent":
                    commons.append(self._expected_ra_rnti())
                res = self.dl.receive(rgrid, sf, commons, self.ue.crnti)
                self._ue_dl_process(res, sfn, sf)
            # PRACH occasion
            if sf == cfg.prach_sf:
                self._prach_tti()
            # UL due this TTI
            if self.tti in self._ul_due:
                rnti, alloc, kind = self._ul_due.pop(self.tti)
                tbs = self.ul.tbs_bytes(alloc, sf)
                pdu = self._ue_build_ul_pdu(kind, tbs)
                self.phy_runs["ul"] += 1
                data = self.ul.run(alloc, rnti, sf, pdu)
                self._grant_outstanding = False
                if data is not None:
                    self._enb_ul_process(data, rnti, kind)
            # UE app: once REGISTERED + DRB up, send one IP packet
            if (not self.ue_echo_sent
                    and self.ue.nas.state == UeEmmState.REGISTERED
                    and self.ue.drb is not None):
                self.ue_echo_sent = True
                self.ue.drb.tx_enqueue(
                    self.ue.pdcp_ul.data_req(ip_payload))
                if self.pcap is not None:
                    self.pcap.write(ip_payload, tti=self.tti,
                                    direction=DIR_UL, kind=KIND_IP)
                self._ev("UE queued uplink IP packet on the DRB")
            # eNB: forward any SGW downlink into the DRB
            if self.enb_drb is not None:
                for crnti, pkt in self.enb_app.poll_downlink_user():
                    self.enb_drb_txq.append(
                        self.enb_pdcp_dl.data_req(pkt))
                    self._ev("eNB queued downlink IP packet (GTP-U -> DRB)")
            # MME-originated big NAS after registration (EMM INFORMATION
            # larger than any grant -> RLC-AM segmentation end-to-end)
            if (cfg.big_nas_bytes and not self._big_nas_sent
                    and self._mme_registered()
                    and self._crnti in self.enb_app.by_crnti):
                self._big_nas_sent = True
                mme_ue_id = self.enb_app.by_crnti[self._crnti].mme_ue_id
                self.enb_app.handle_mme_initiated(self.mme.emm_information(
                    mme_ue_id, bytes(i & 0xFF
                                     for i in range(cfg.big_nas_bytes))))
                self._ev(f"MME sends {cfg.big_nas_bytes}B EMM INFORMATION")
            # drain MME->UE NAS queued outside a UL exchange
            if self._crnti in self.enb_app.by_crnti:
                for nas in self.enb_app.poll_nas(self._crnti):
                    self._enb_queue_srb1(DlInformationTransfer(
                        dedicated_info_nas=nas).pack())
            # timers
            self.enb_rrc.tick()
            self.ue.rrc.tick()
            self.ue.srb1.tick()
            self.enb_srb1.tick()
            if self.ue.drb is not None:
                self.ue.drb.tick()
            if self.enb_drb is not None:
                self.enb_drb.tick()
            self.tti += 1
            # stop once the echo landed AND the MME saw AttachComplete
            # (AND the oversized NAS fully reassembled, when configured)
            if self.ue.delivered_ip and self._mme_registered() and \
                    (not cfg.big_nas_bytes
                     or len(self.ue.nas.network_name) == cfg.big_nas_bytes):
                break

        echo_ok = bool(self.ue.delivered_ip
                       and self.ue.delivered_ip[0] == ip_payload)
        crnti = self._crnti
        as_secured = bool(crnti is not None
                          and crnti in self.enb_rrc.ues
                          and self.enb_rrc.ues[crnti].as_secured)
        result = dict(
            registered=self.ue.nas.state == UeEmmState.REGISTERED,
            mme_registered=self._mme_registered(),
            rrc_connected=self.ue.rrc.state == RrcState.CONNECTED,
            as_secured=as_secured,
            srb_integrity_on=bool(
                self.ue.srb_pdcp_tx.integrity_on
                and self.ue.srb_pdcp_rx._rx_state == "on"
                and self.enb_srb_pdcp_rx._rx_state == "on"),
            srb_int_failures=(self.ue.srb_pdcp_rx.int_failures
                              + self.enb_srb_pdcp_rx.int_failures),
            echo_ok=echo_ok,
            big_nas_ok=(len(self.ue.nas.network_name) == cfg.big_nas_bytes
                        if cfg.big_nas_bytes else None),
            ue_ip=self.ue.nas.ip,
            ttis=self.tti,
            phy_runs=dict(self.phy_runs),
            paged=self.ue_paged and self.cfg.mt_attach,
            po_monitored=self.po_monitored,
            trace=list(self.trace),
            msc_events=len(self.msc.events))
        if self._artifact_dir is not None:
            self.msc.save(f"{self._artifact_dir}/capstone.msc")
            self.pcap.close()
            result["artifacts"] = dict(
                msc=f"{self._artifact_dir}/capstone.msc",
                pcap=f"{self._artifact_dir}/capstone.pcap",
                pcap_records=self.pcap.n_records)
        return result


def main(argv=None):
    import argparse
    import json
    from ..device import cli_device
    p = argparse.ArgumentParser(
        description="full-stack over-the-air attach + bearer run")
    p.add_argument("-s", "--snr", type=float, default=12.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--artifacts", type=str, default=None)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exits without a card) or cpu")
    a = p.parse_args(argv)
    dev = cli_device("capstone", a.device)
    if a.verbose:
        from ..utils.log import set_global_log
        set_global_log("info")
    sim = FullStackSim(CapstoneConfig(snr_db=a.snr, seed=a.seed),
                       artifact_dir=a.artifacts, device=dev)
    res = sim.run()
    res.pop("trace")
    print(json.dumps(res, indent=2, default=str))


if __name__ == "__main__":
    main()
