"""oaisim full-stack mode: N UEs x M eNBs with the COMPLETE protocol
stack — RRC/NAS state machines, SRB1 PDCP integrity, RLC-AM/UM, 36.321
MAC multiplexing, RA with real contention resolution, and the EPC slice
(S1AP/MME/SGW/GTP-U) — in the per-TTI emulation loop.

Reference parity: targets/SIMU/USER/oaisim.c in abstraction mode (`-a`):
the reference's oaisim always runs the full L2/L3 stack per TTI
(oaisim.c:760-938 calls the MAC scheduler and the complete eNB/UE PHY
procedures; with PHY_ABSTRACTION the bit-level PHY is replaced by
SINR -> BLER draws, dlsch_decoding.c:524, but RRC connection
establishment, NAS attach and user-plane data still ride real RLC/PDCP
PDUs). This module is that composition: every control and user byte
crosses the MAC as a real 36.321 PDU; only the transport-block
success/failure is drawn from the abstraction BLER curve.

The bit-level single-UE equivalent (every PDU through the actual PHY) is
sim/capstone.py; the batched MAC+PHY system emulator with mobility and
handover is sim/oaisim.py. This mode adds what neither exercises: many
UEs climbing the whole ladder concurrently through one MAC, with
preamble collisions, per-UE AS security, and RLC-AM recovery under MAC
transport-block loss.

TPU note: the protocol stack is host bytework by nature (as in the
reference); the abstraction BLER machinery it draws from is the same
calibrated EESM/BLER-table stack the device-mode oaisim uses.

A copy of openair4g_tpu/sim/oaisim_fullstack.py, command line included
(`python3 -m openair4g_tpu_torch.sim.oaisim_fullstack -u 4`): it looks
its BLER up with np.interp and draws from numpy, so it runs nothing on
the device, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..mac.mux import (pack_mac_pdu, unpack_mac_pdu,
                       pack_contention_resolution,
                       contention_resolution_matches, LCID_CCCH,
                       LCID_CONTENTION_RESOLUTION, LCID_SHORT_BSR)
from ..mac.ra import Rar, pack_rar, unpack_rar, ra_rnti, RaProcedure
from ..mac.rlc import (RlcAm, RlcUm, StatusPdu, pack_am, unpack_am,
                       pack_am_status, pack_um, unpack_um)
from ..mac.ue_mac import pack_short_bsr
from ..mac.pdcp import PdcpEntity, PdcpConfig
from ..rrc.enb import RrcEnb, UeState
from ..rrc.ue import RrcUe, RrcState
from ..rrc.messages import (Sib1, Sib2, RrcConnectionSetupComplete,
                            RrcConnectionReconfiguration,
                            DlInformationTransfer, UlInformationTransfer,
                            SecurityModeCommand, SecurityModeComplete,
                            decode_message)
from ..epc.security import derive_k_enb, derive_k_rrc_int
from ..epc.hss import Hss
from ..epc.mme import Mme, EmmState
from ..epc.sgw import SgwPgw
from ..epc.enb_app import EnbApp
from ..epc.ue_nas import UeNas, UeEmmState
from ..utils.log import LOG_I, LOG_D, LOG_W
from .abstraction import BlerTable
from .oaisim import default_bler_table

LCID_SRB1 = 1
LCID_DRB = 3
LCID_DRB2 = 4                        # dedicated bearer's DRB (EBI 6)
VOICE_PORT = 7070                    # the dedicated bearer's TFT port


def _srb_pdcp(direction: int) -> PdcpEntity:
    return PdcpEntity(PdcpConfig(sn_bits=5, bearer=1, integrity=True,
                                 direction=direction))


@dataclass(frozen=True)
class FullStackScenario:
    n_ue: int = 4
    n_enb: int = 1
    snr_db: float = 14.0             # per-link SNR at the BLER table
    snr_spread_db: float = 2.0       # per-UE uniform spread
    mcs: int = 8                     # sets the abstraction BLER curve
    tbs_bytes: int = 96              # MAC TB size for SRB/DRB TTIs
    dl_grants_per_tti: int = 2       # MAC scheduler DL capacity
    ul_grants_per_tti: int = 2
    prach_sf: int = 1
    n_preambles: int = 8             # small pool -> real collisions
    harq_rounds: int = 4             # MAC-level retx before dropping a TB
    max_frames: int = 200
    seed: int = 0
    imsi_base: int = 208950000000100
    post_attach: str | None = None   # after attach+echo, drive a NAS
    #   procedure over the air: "detach" (UE-initiated, §5.5.2.2),
    #   "tau" (connected-mode tracking area update + GUTI realloc) or
    #   "service_request" (network releases the UE to ECM-IDLE with the
    #   context kept; the UE re-runs RA and sends ServiceRequest as the
    #   initial NAS with its S-TMSI; bearer re-established; 2nd echo) or
    #   "dedicated_bearer" (network-initiated dedicated bearer with a
    #   TFT: E-RAB Setup + NAS activation over the air, then a voice
    #   flow on DRB2/EBI-6 and the data echo on the default DRB — two
    #   flows over two GTP-U tunnels)


@dataclass
class UeFull:
    """One UE's complete stack (no PHY: the air is the BLER draw)."""
    ue_id: int
    rrc: RrcUe
    nas: UeNas
    snr_db: float
    serving: int = 0
    ra: RaProcedure | None = None
    srb1: RlcAm = field(default_factory=lambda: RlcAm(poll_every=2))
    srb_pdcp_tx: PdcpEntity = field(default_factory=lambda: _srb_pdcp(0))
    srb_pdcp_rx: PdcpEntity = field(default_factory=lambda: _srb_pdcp(0))
    drb: RlcUm | None = None
    pdcp_ul: PdcpEntity | None = None
    pdcp_dl: PdcpEntity | None = None
    drb2: RlcUm | None = None
    pdcp2_ul: PdcpEntity | None = None
    pdcp2_dl: PdcpEntity | None = None
    srb1_txq: list = field(default_factory=list)
    status_txq: list = field(default_factory=list)
    msg3: bytes | None = None
    crnti: int | None = None
    delivered_ip: list = field(default_factory=list)
    delivered_voice: list = field(default_factory=list)
    voice_sent: bool = False
    voice_tti: int = 0
    echo_sent: bool = False
    echo_tti: int = 0
    ra_attempts: int = 0
    ra_tti: int = 0              # when the preamble went out (RAR window)
    contention_losses: int = 0
    post_started: bool = False   # post-attach NAS procedure launched
    want_echoes: int = 1         # 2 for the service-request cycle

    def queue_srb1(self, rrc_sdu: bytes) -> None:
        self.srb1_txq.append(self.srb_pdcp_tx.data_req(rrc_sdu))

    @property
    def sr_pending(self) -> bool:
        return bool(self.msg3 is not None or self.srb1_txq
                    or self.status_txq or self.srb1.has_data()
                    or (self.drb is not None and self.drb._txq)
                    or (self.drb2 is not None and self.drb2._txq))


@dataclass
class EnbUeL2:
    """eNB-side per-UE L2 context (srb/drb entities + tx queues)."""
    crnti: int
    srb1: RlcAm = field(default_factory=lambda: RlcAm(poll_every=2))
    srb_pdcp_tx: PdcpEntity = field(default_factory=lambda: _srb_pdcp(1))
    srb_pdcp_rx: PdcpEntity = field(default_factory=lambda: _srb_pdcp(1))
    drb: RlcUm | None = None
    pdcp_dl: PdcpEntity | None = None
    pdcp_ul: PdcpEntity | None = None
    drb2: RlcUm | None = None
    pdcp2_dl: PdcpEntity | None = None
    pdcp2_ul: PdcpEntity | None = None
    srb1_txq: list = field(default_factory=list)
    status_txq: list = field(default_factory=list)
    drb_txq: list = field(default_factory=list)
    drb2_txq: list = field(default_factory=list)
    msg4: tuple | None = None        # (cr_ce, setup_bytes)
    msg3_seen: bytes | None = None
    smc_sent: bool = False
    reconf_sent: bool = False

    def queue_srb1(self, rrc_sdu: bytes) -> None:
        self.srb1_txq.append(self.srb_pdcp_tx.data_req(rrc_sdu))

    @property
    def dl_pending(self) -> bool:
        return bool(self.msg4 is not None or self.srb1_txq
                    or self.status_txq or self.srb1.has_data()
                    or self.drb_txq or self.drb2_txq
                    or (self.drb is not None and self.drb._txq)
                    or (self.drb2 is not None and self.drb2._txq))


class OaisimFullStack:
    """The emulation driver: per-TTI MAC scheduling over all UEs, one
    shared EPC, abstraction-mode air."""

    def __init__(self, sc: FullStackScenario = FullStackScenario()):
        self.sc = sc
        self.rng = np.random.default_rng(sc.seed)
        self.table: BlerTable = default_bler_table(sc.mcs)
        hss = Hss()
        self.sgw = SgwPgw()
        self.mme = Mme(hss, self.sgw)
        self.enb_rrc = [RrcEnb(sib1=Sib1(), sib2=Sib2())
                        for _ in range(sc.n_enb)]
        self.enb_app = [EnbApp(self.mme, self.sgw, enb_id=0x19B + e,
                               addr=0x0A000002 + e)
                        for e in range(sc.n_enb)]
        self.l2: list[dict[int, EnbUeL2]] = [{} for _ in range(sc.n_enb)]
        self.ues: list[UeFull] = []
        for u in range(sc.n_ue):
            imsi = sc.imsi_base + u
            k = bytes((u + i) & 0xFF for i in range(16))
            hss.provision(imsi, k)
            ue = UeFull(ue_id=u, rrc=RrcUe(seed=sc.seed * 100 + u),
                        nas=UeNas(imsi, k),
                        snr_db=sc.snr_db + float(
                            self.rng.uniform(-1, 1)) * sc.snr_spread_db,
                        serving=u % sc.n_enb)
            # camped: cell search is the capstone's job; here the ladder
            # starts at SI acquisition (reference -a runs begin camped too)
            ue.rrc.state = RrcState.IDLE_SIB
            ue.rrc.n_id_cell = ue.serving
            from ..rrc.messages import Mib
            ue.rrc.mib = Mib()
            self.ues.append(ue)
        self.tti = 0
        # in-flight MAC transport blocks: list of dicts with delivery TTI
        self._rar_due: list = []     # (due_tti, enb, rar, ra_rnti)
        self._ul_due: dict = {}      # tti -> list of (enb, ue_id, kind)
        self._grant_out: set = set()  # ue_ids with an outstanding UL grant
        self._dl_retx: list = []     # pending DL TBs (HARQ rounds left)
        self.stats = dict(dl_tb=0, dl_tb_lost=0, ul_tb=0, ul_tb_lost=0,
                          prach=0, collisions=0, rlc_retx=0)
        self.trace: list = []

    # ---------------------------------------------------------------- air --
    def _deliver(self, ue: UeFull) -> bool:
        """One transport block over the abstraction air: BLER(SNR) draw
        (dlsch_decoding.c:524 coin flip)."""
        bler = float(np.exp(np.interp(
            ue.snr_db, self.table.snr_db, self.table.log_bler,
            left=0.0, right=self.table.log_bler[-1])))
        return bool(self.rng.random() > bler)

    def _ev(self, what: str):
        self.trace.append((self.tti, what))
        LOG_D("SIM", "t=%d %s", self.tti, what)

    # ------------------------------------------------------------- eNB DL --
    def _enb_dl_tti(self, sfn: int, sf: int):
        sc = self.sc
        for e in range(sc.n_enb):
            # BCCH: SI to every camped UE of this cell (broadcast: one
            # independent draw per UE, like per-UE SINR in the reference)
            si = self.enb_rrc[e].bcch_schedule(sfn, sf)
            if si is not None:
                for ue in self.ues:
                    if ue.serving == e and ue.rrc.state in (
                            RrcState.IDLE_SIB, RrcState.IDLE_READY):
                        if self._deliver(ue):
                            ue.rrc.on_bcch(si)
            # RARs due
            for item in list(self._rar_due):
                due, enb, rar, rarnti = item
                if enb != e or self.tti < due:
                    continue
                self._rar_due.remove(item)
                self.stats["dl_tb"] += 1
                for ue in self.ues:
                    if (ue.serving == e and ue.ra is not None
                            and ue.ra.state == "preamble_sent"
                            and self._deliver(ue)):
                        if ue.ra.on_rar(rar):
                            ue.crnti = rar.t_crnti
                            ue.msg3 = ue.rrc.connection_request()
                            ue.ra_attempts += 1
                            self._ul_due.setdefault(
                                self.tti + 6, []).append(
                                    (e, ue.ue_id, "msg3"))
                            self._ev(f"ue{ue.ue_id} matched RAR "
                                     f"(rapid={rar.rapid})")
            # dedicated DL: scheduler picks UEs with pending work
            cands = [(crnti, l2) for crnti, l2 in self.l2[e].items()
                     if l2.dl_pending]
            rot = self.tti % max(len(cands), 1)
            cands = cands[rot:] + cands[:rot]
            for crnti, l2 in cands[:sc.dl_grants_per_tti]:
                pdu = self._build_dl_pdu(e, l2)
                if pdu is None:
                    continue
                self.stats["dl_tb"] += 1
                # every UE holding this (T-)C-RNTI monitors it — after a
                # preamble collision that is ALL contenders (36.321 §5.1.5)
                targets = self._ues_by_crnti(e, crnti)
                if not targets:
                    continue
                delivered = False
                for ue in targets:
                    if self._deliver(ue):
                        delivered = True
                        self._ue_dl_mac(ue, e, pdu)
                if not delivered:
                    self.stats["dl_tb_lost"] += 1   # RLC-AM will recover
            # UL grants for SR-pending UEs
            granted = 0
            for ue in self.ues:
                if granted >= sc.ul_grants_per_tti:
                    break
                if (ue.serving == e and ue.crnti is not None
                        and ue.crnti in self.l2[e]
                        and ue.sr_pending and ue.ue_id not in
                        self._grant_out and ue.msg3 is None):
                    self._ul_due.setdefault(self.tti + 4, []).append(
                        (e, ue.ue_id, "data"))
                    self._grant_out.add(ue.ue_id)
                    granted += 1

    def _ues_by_crnti(self, e: int, crnti: int) -> list:
        return [ue for ue in self.ues
                if ue.serving == e and ue.crnti == crnti]

    def _build_dl_pdu(self, e: int, l2: EnbUeL2) -> bytes | None:
        sc = self.sc
        tbs = sc.tbs_bytes
        if l2.msg4 is not None:
            cr, setup = l2.msg4
            l2.msg4 = None
            return pack_mac_pdu([(LCID_CONTENTION_RESOLUTION, cr),
                                 (LCID_CCCH, setup)], tbs)
        subs = []
        budget = tbs - 8
        for st in l2.status_txq[:]:
            raw = pack_am_status(st)
            if len(raw) <= budget:
                subs.append((LCID_SRB1, raw))
                budget -= len(raw) + 2
                l2.status_txq.remove(st)
        # size-fitted AM PDUs: segmentation to the grant + SO-based
        # re-segmentation of retransmissions (rlc_am_segment.c parity)
        for sdu in l2.srb1_txq:
            l2.srb1.tx_enqueue(sdu)
        l2.srb1_txq.clear()
        while budget > 16 and l2.srb1.has_data():
            if l2.srb1._retx_q:
                self.stats["rlc_retx"] += 1
            pdu = l2.srb1.tx_pdu(size=budget - 12)
            if pdu is None:
                break
            raw = pack_am(pdu)
            subs.append((LCID_SRB1, raw))
            budget -= len(raw) + 2
        if l2.drb is not None:
            for p in l2.drb_txq:
                l2.drb.tx_enqueue(p)
            l2.drb_txq.clear()
            while budget > 6 and l2.drb._txq:
                um = l2.drb.tx_pdu(budget - 6)
                if um is None:
                    break
                raw = pack_um(um)
                subs.append((LCID_DRB, raw))
                budget -= len(raw) + 2
        if l2.drb2 is not None:
            for p in l2.drb2_txq:
                l2.drb2.tx_enqueue(p)
            l2.drb2_txq.clear()
            while budget > 6 and l2.drb2._txq:
                um = l2.drb2.tx_pdu(budget - 6)
                if um is None:
                    break
                raw = pack_um(um)
                subs.append((LCID_DRB2, raw))
                budget -= len(raw) + 2
        return pack_mac_pdu(subs, tbs) if subs else None

    # -------------------------------------------------------------- UE DL --
    def _ue_dl_mac(self, ue: UeFull, e: int, pdu: bytes):
        for lcid, payload in unpack_mac_pdu(pdu):
            if lcid == LCID_CONTENTION_RESOLUTION:
                if ue.ra is None or ue.msg3 is None:
                    continue
                won = contention_resolution_matches(payload, ue.msg3)
                ue.ra.on_contention_resolution(won)
                if won:
                    ue.msg3 = None
                    self._ev(f"ue{ue.ue_id} won contention")
                else:
                    # 36.321 §5.1.5: discard T-CRNTI, restart RA
                    ue.contention_losses += 1
                    self.stats["collisions"] += 1
                    ue.crnti = None
                    ue.msg3 = None
                    ue.ra = None
                    ue.rrc.state = RrcState.IDLE_READY
                    ue.rrc._t300 = None
                    self._ev(f"ue{ue.ue_id} LOST contention -> re-RA")
            elif lcid == LCID_CCCH:
                if ue.rrc.state == RrcState.CONNECTED:
                    continue        # stray Msg4 on a recycled RNTI
                resp = ue.rrc.on_ccch(ue.crnti, payload)
                if resp is not None:
                    sc_msg = decode_message(resp)
                    if ue.nas.state == UeEmmState.REGISTERED:
                        # ECM-IDLE return: ServiceRequest as initial NAS
                        # with the S-TMSI riding SetupComplete (24.301
                        # §5.6.1 / emm SAP)
                        sc_msg.s_tmsi = ue.nas.guti & ((1 << 48) - 1)
                        sc_msg.dedicated_info_nas = ue.nas.service_request()
                        self._ev(f"ue{ue.ue_id} ServiceRequest (S-TMSI)")
                    else:
                        sc_msg.dedicated_info_nas = ue.nas.attach_request()
                    ue.queue_srb1(sc_msg.pack())
                elif ue.rrc.state == RrcState.IDLE_READY:
                    # identity mismatch: this Msg4 was for the collision
                    # winner; we restart RA
                    ue.contention_losses += 1
                    self.stats["collisions"] += 1
                    ue.crnti = None
                    ue.msg3 = None
                    ue.ra = None
                    ue.rrc._t300 = None
                    self._ev(f"ue{ue.ue_id} lost contention (Msg4) "
                             "-> re-RA")
            elif lcid == LCID_SRB1:
                if ue.rrc.state != RrcState.CONNECTED:
                    # a collision loser that missed Msg4 still monitors
                    # the shared T-CRNTI; DCCH is not for it
                    continue
                rlc = unpack_am(payload)
                if isinstance(rlc, StatusPdu):
                    ue.srb1.on_status(rlc)
                    continue
                n0 = len(ue.srb1.delivered)
                st = ue.srb1.rx_pdu(rlc)
                if st is not None:
                    ue.status_txq.append(st)
                for pp in ue.srb1.delivered[n0:]:
                    sdu = ue.srb_pdcp_rx.data_ind(pp)
                    if sdu is None:
                        LOG_W("PDCP", "ue%d SRB1 PDU discarded", ue.ue_id)
                        continue
                    self._ue_dcch(ue, e, sdu)
            elif lcid == LCID_DRB and ue.drb is not None:
                n0 = len(ue.drb.delivered)
                ue.drb.rx_pdu(unpack_um(payload))
                for sdu in ue.drb.delivered[n0:]:
                    pkt = ue.pdcp_dl.data_ind(sdu)
                    if pkt is not None:
                        ue.delivered_ip.append(pkt)
                        self._ev(f"ue{ue.ue_id} received IP echo")
            elif lcid == LCID_DRB2 and ue.drb2 is not None:
                n0 = len(ue.drb2.delivered)
                ue.drb2.rx_pdu(unpack_um(payload))
                for sdu in ue.drb2.delivered[n0:]:
                    pkt = ue.pdcp2_dl.data_ind(sdu)
                    if pkt is not None:
                        ue.delivered_voice.append(pkt)
                        self._ev(f"ue{ue.ue_id} received voice (DRB2)")

    def _ue_dcch(self, ue: UeFull, e: int, sdu: bytes):
        msg = decode_message(sdu)
        if isinstance(msg, SecurityModeCommand):
            k_int = derive_k_rrc_int(derive_k_enb(ue.nas.kasme))
            ue.srb_pdcp_tx.activate_tx(k_int)
            ue.queue_srb1(SecurityModeComplete().pack())
            self._ev(f"ue{ue.ue_id} AS security on")
            return
        if isinstance(msg, DlInformationTransfer):
            resp = ue.nas.handle_downlink(msg.dedicated_info_nas)
            if ue.nas.kasme and ue.srb_pdcp_rx._rx_state == "off":
                ue.srb_pdcp_rx.arm_rx(
                    derive_k_rrc_int(derive_k_enb(ue.nas.kasme)))
            if resp is not None:
                ue.queue_srb1(UlInformationTransfer(
                    dedicated_info_nas=resp).pack())
            return
        if isinstance(msg, RrcConnectionReconfiguration):
            resp = ue.rrc.on_dcch(sdu)
            if msg.drb_add and ue.drb is None:
                ue.drb = RlcUm()
                ue.pdcp_ul = PdcpEntity(PdcpConfig(
                    bearer=msg.drb_identity, ciphering="xor"))
                ue.pdcp_dl = PdcpEntity(PdcpConfig(
                    bearer=msg.drb_identity, ciphering="xor"))
                self._ev(f"ue{ue.ue_id} DRB established")
            if resp is not None:
                ue.queue_srb1(resp)
            return
        resp = ue.rrc.on_dcch(sdu)
        if resp is not None:
            ue.queue_srb1(resp)

    # ------------------------------------------------------------- PRACH --
    def _prach_tti(self):
        sc = self.sc
        by_cell: dict[int, dict[int, list[UeFull]]] = {}
        for ue in self.ues:
            if (ue.rrc.state == RrcState.IDLE_READY
                    and (ue.ra is None or ue.ra.state == "idle")):
                v = int(self.rng.integers(0, sc.n_preambles))
                ue.ra = RaProcedure(preamble=v)
                ue.ra.send_preamble()
                ue.ra_tti = self.tti
                self.stats["prach"] += 1
                by_cell.setdefault(ue.serving, {}).setdefault(
                    v, []).append(ue)
                self._ev(f"ue{ue.ue_id} PRACH preamble {v}")
        for e, by_preamble in by_cell.items():
            for v in by_preamble:
                # one RAR per detected preamble: colliding UEs share it
                t_crnti = self.enb_rrc[e].reserve_crnti()
                rar = Rar(rapid=v, timing_advance=0,
                          ul_grant=(0 << 15) | (4 << 10) | (4 << 5),
                          t_crnti=t_crnti)
                self._rar_due.append((self.tti + 3, e, rar,
                                      ra_rnti(self.tti % 10)))

    # ---------------------------------------------------------------- UL --
    def _ul_tti(self):
        sc = self.sc
        for e, ue_id, kind in self._ul_due.pop(self.tti, []):
            ue = self.ues[ue_id]
            self._grant_out.discard(ue_id)
            if kind == "msg3":
                # collision model: every UE that matched the same RAR
                # transmits Msg3 on the SAME grant; the eNB decodes at
                # most ONE per (cell, tti, t_crnti) — the first whose
                # draw succeeds (capture effect). The losers learn their
                # fate from the contention-resolution CE in Msg4.
                if ue.msg3 is None:
                    continue
                self.stats["ul_tb"] += 1
                key = (e, self.tti, ue.crnti)
                taken = getattr(self, "_msg3_taken", None)
                if taken is None:
                    taken = self._msg3_taken = set()
                if not self._deliver(ue) or key in taken:
                    self.stats["ul_tb_lost"] += 1
                    continue
                taken.add(key)
                pdu = pack_mac_pdu([(LCID_CCCH, ue.msg3)], 16)
                self._enb_msg3(e, ue, pdu)
            else:
                if not ue.sr_pending:
                    continue
                self.stats["ul_tb"] += 1
                pdu = self._build_ul_pdu(ue)
                if self._deliver(ue):
                    self._enb_ul_mac(e, ue, pdu)
                else:
                    self.stats["ul_tb_lost"] += 1

    def _build_ul_pdu(self, ue: UeFull) -> bytes:
        tbs = self.sc.tbs_bytes
        subs = [(LCID_SHORT_BSR, pack_short_bsr(
            0, sum(len(s) for s in ue.srb1_txq)
            + sum(len(s) for s in ue.srb1._txq)))]
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
            if ue.srb1._retx_q:
                self.stats["rlc_retx"] += 1
            pdu = ue.srb1.tx_pdu(size=budget - 12)
            if pdu is None:
                break
            raw = pack_am(pdu)
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
        if ue.drb2 is not None:
            while budget > 6 and ue.drb2._txq:
                um = ue.drb2.tx_pdu(budget - 6)
                if um is None:
                    break
                raw = pack_um(um)
                subs.append((LCID_DRB2, raw))
                budget -= len(raw) + 2
        return pack_mac_pdu(subs, tbs)

    # ------------------------------------------------------------- eNB UL --
    def _enb_msg3(self, e: int, ue: UeFull, pdu: bytes):
        subs = unpack_mac_pdu(pdu)
        assert subs and subs[0][0] == LCID_CCCH
        msg3_sdu = subs[0][1]
        crnti, setup = self.enb_rrc[e].handle_ccch(msg3_sdu,
                                                   crnti=ue.crnti)
        l2 = EnbUeL2(crnti=crnti)
        l2.msg3_seen = msg3_sdu
        l2.msg4 = (pack_contention_resolution(msg3_sdu), setup)
        self.l2[e][crnti] = l2
        self._ev(f"eNB{e} Msg3 -> C-RNTI {crnti:#x}")

    def _enb_ul_mac(self, e: int, ue: UeFull, pdu: bytes):
        l2 = self.l2[e].get(ue.crnti)
        if l2 is None:
            return
        for lcid, payload in unpack_mac_pdu(pdu):
            if lcid == LCID_SHORT_BSR:
                continue
            if lcid == LCID_SRB1:
                rlc = unpack_am(payload)
                if isinstance(rlc, StatusPdu):
                    l2.srb1.on_status(rlc)
                    continue
                n0 = len(l2.srb1.delivered)
                st = l2.srb1.rx_pdu(rlc)
                if st is not None:
                    l2.status_txq.append(st)
                for pp in l2.srb1.delivered[n0:]:
                    sdu = l2.srb_pdcp_rx.data_ind(pp)
                    if sdu is None:
                        LOG_W("PDCP", "eNB%d SRB1 PDU discarded", e)
                        continue
                    self._enb_dcch(e, ue, l2, sdu)
            elif lcid == LCID_DRB and l2.drb is not None:
                n0 = len(l2.drb.delivered)
                l2.drb.rx_pdu(unpack_um(payload))
                for sdu in l2.drb.delivered[n0:]:
                    pkt = l2.pdcp_ul.data_ind(sdu)
                    if pkt is not None:
                        self.enb_app[e].uplink_user(l2.crnti, pkt)
            elif lcid == LCID_DRB2 and l2.drb2 is not None:
                n0 = len(l2.drb2.delivered)
                l2.drb2.rx_pdu(unpack_um(payload))
                app = self.enb_app[e]
                ctx = app.by_crnti.get(l2.crnti)
                ded = next(iter(ctx.erabs)) if ctx and ctx.erabs else None
                for sdu in l2.drb2.delivered[n0:]:
                    pkt = l2.pdcp2_ul.data_ind(sdu)
                    if pkt is not None and ded is not None:
                        app.uplink_user(l2.crnti, pkt, ebi=ded)

    def _enb_dcch(self, e: int, ue: UeFull, l2: EnbUeL2, sdu: bytes):
        msg = decode_message(sdu)
        app = self.enb_app[e]
        rrc = self.enb_rrc[e]
        if isinstance(msg, RrcConnectionSetupComplete):
            rrc.handle_dcch(l2.crnti, sdu)
            # the 48-bit field carries the full GUTI (mme_group 4 /
            # mme_code 1 / M-TMSI fit well under 2^48)
            app.initial_ue_message(l2.crnti, msg.dedicated_info_nas,
                                   s_tmsi=msg.s_tmsi)
        elif isinstance(msg, UlInformationTransfer):
            app.uplink_nas(l2.crnti, msg.dedicated_info_nas)
        else:
            resp = rrc.handle_dcch(l2.crnti, sdu)
            if resp is not None:
                l2.queue_srb1(resp)
        ctx = app.by_crnti.get(l2.crnti)
        if (ctx and ctx.security_key and not l2.smc_sent
                and rrc.ues[l2.crnti].state == UeState.CONNECTED):
            l2.smc_sent = True
            k_int = derive_k_rrc_int(ctx.security_key)
            l2.srb_pdcp_tx.activate_tx(k_int)
            l2.srb_pdcp_rx.arm_rx(k_int)
            l2.queue_srb1(rrc.security_mode_command(l2.crnti))
            self._ev(f"eNB{e} SMC -> ue{ue.ue_id}")
        for nas in app.poll_nas(l2.crnti):    # incl. parting NAS after
            l2.queue_srb1(DlInformationTransfer(  # a context release
                dedicated_info_nas=nas).pack())
        if (ctx and ctx.sgw_teid_ul and not l2.reconf_sent
                and rrc.ues[l2.crnti].state == UeState.CONNECTED):
            l2.reconf_sent = True
            l2.queue_srb1(rrc.reconfigure(l2.crnti, drb_add=True))
            l2.drb = RlcUm()
            l2.pdcp_dl = PdcpEntity(PdcpConfig(bearer=1, ciphering="xor"))
            l2.pdcp_ul = PdcpEntity(PdcpConfig(bearer=1, ciphering="xor"))
            self._ev(f"eNB{e} DRB reconfig -> ue{ue.ue_id}")

    def _reset_ue(self, ue: UeFull) -> None:
        """Radio-link-failure recovery: back to IDLE_READY with fresh L2
        (the EPC context is simply re-established by the next attach)."""
        if ue.crnti is not None:
            self.l2[ue.serving].pop(ue.crnti, None)
        ue.crnti = None
        ue.ra = None
        ue.msg3 = None
        ue.srb1 = RlcAm(poll_every=2)
        ue.srb_pdcp_tx = _srb_pdcp(0)
        ue.srb_pdcp_rx = _srb_pdcp(0)
        ue.drb = None
        ue.pdcp_ul = ue.pdcp_dl = None
        ue.drb2 = None
        ue.pdcp2_ul = ue.pdcp2_dl = None
        ue.srb1_txq.clear()
        ue.status_txq.clear()
        ue.echo_sent = False
        ue.rrc.state = RrcState.IDLE_READY
        ue.rrc._t300 = None
        ue.rrc.crnti = None
        # fresh NAS: the MME-lite builds a new unauthenticated context on
        # the next InitialUEMessage, so the UE starts unprotected too
        ue.nas = UeNas(ue.nas.imsi, ue.nas.k)

    def _ue_to_idle(self, ue: UeFull) -> None:
        """ECM-IDLE transition (RRC release, EMM context KEPT): fresh L2
        entities, NAS security context and GUTI survive so the UE can
        return with a ServiceRequest (24.301 §5.6.1)."""
        if ue.crnti is not None:
            self.l2[ue.serving].pop(ue.crnti, None)
        ue.crnti = None
        ue.ra = None
        ue.msg3 = None
        ue.srb1 = RlcAm(poll_every=2)
        ue.srb_pdcp_tx = _srb_pdcp(0)
        ue.srb_pdcp_rx = _srb_pdcp(0)
        if ue.nas.kasme:
            k_int = derive_k_rrc_int(derive_k_enb(ue.nas.kasme))
            ue.srb_pdcp_tx.activate_tx(k_int)
            ue.srb_pdcp_rx.arm_rx(k_int)
        ue.drb = None
        ue.pdcp_ul = ue.pdcp_dl = None
        ue.drb2 = None
        ue.pdcp2_ul = ue.pdcp2_dl = None
        ue.srb1_txq.clear()
        ue.status_txq.clear()
        ue.echo_sent = False
        ue.rrc.state = RrcState.IDLE_READY
        ue.rrc._t300 = None
        ue.rrc.crnti = None

    # --------------------------------------------------------------- run --
    def run(self) -> dict:
        sc = self.sc
        ip_payload = b"oaisim-fullstack-ping-"
        while self.tti < sc.max_frames * 10:
            sfn, sf = self.tti // 10, self.tti % 10
            self._enb_dl_tti(sfn, sf)
            if sf == sc.prach_sf:
                self._prach_tti()
            self._ul_tti()
            # app layer: one echo per registered UE (re-sent on a simple
            # app timeout — the DRB rides RLC-UM, which does not ARQ)
            for ue in self.ues:
                if (ue.nas.state == UeEmmState.REGISTERED
                        and ue.drb is not None
                        and len(ue.delivered_ip) < ue.want_echoes
                        and (not ue.echo_sent
                             or (self.tti - ue.echo_tti) > 100)):
                    ue.echo_sent = True
                    ue.echo_tti = self.tti
                    ue.drb.tx_enqueue(ue.pdcp_ul.data_req(
                        ip_payload + bytes([ue.ue_id])))
                    self._ev(f"ue{ue.ue_id} queued IP packet")
            for e in range(sc.n_enb):
                app = self.enb_app[e]
                for crnti, ebi, pkt in app.poll_downlink_user_bearers():
                    l2 = self.l2[e].get(crnti)
                    if l2 is None:
                        continue
                    ctx = app.by_crnti.get(crnti)
                    on_dedicated = (ctx is not None and ebi in ctx.erabs)
                    if on_dedicated and l2.pdcp2_dl is not None:
                        l2.drb2_txq.append(l2.pdcp2_dl.data_req(pkt))
                    elif l2.pdcp_dl is not None:
                        l2.drb_txq.append(l2.pdcp_dl.data_req(pkt))
            # timers
            for e in range(sc.n_enb):
                dropped = self.enb_rrc[e].tick()
                for crnti in dropped:
                    self.l2[e].pop(crnti, None)
                for crnti, l2 in list(self.l2[e].items()):
                    l2.srb1.tick()
                    if l2.drb is not None:
                        l2.drb.tick()
                    if l2.srb1.rlf:
                        # eNB-side RLF: release the UE context (the
                        # reference's ULSCH_max_consecutive_errors drop)
                        self._ev(f"eNB{e} RLF -> release crnti {crnti:#x}")
                        self.l2[e].pop(crnti, None)
                        self.enb_rrc[e].ues.pop(crnti, None)
            for ue in self.ues:
                if ue.rrc.tick() == "retry_ra":
                    ue.ra = None
                # RAR window expiry (36.321 §5.1.4): retry with ramping
                if (ue.ra is not None and ue.ra.state == "preamble_sent"
                        and self.tti - ue.ra_tti > 10):
                    if ue.ra.on_rar_window_expiry() == "retry":
                        ue.ra = None           # next PRACH occasion
                    self._ev(f"ue{ue.ue_id} RAR window expired")
                ue.srb1.tick()
                if ue.drb is not None:
                    ue.drb.tick()
                # radio link failure (RLC-AM maxRetx) or the eNB dropped
                # our context: reset to idle and redo the ladder
                # (rrc_UE ra_failed / phy_reset_ue parity)
                enb_gone = (ue.rrc.state == RrcState.CONNECTED
                            and ue.crnti is not None
                            and ue.crnti not in self.l2[ue.serving]
                            and ue.ra is not None
                            and ue.ra.state == "connected")
                if ue.srb1.rlf or enb_gone:
                    self._ev(f"ue{ue.ue_id} RLF -> reset to idle")
                    self._reset_ue(ue)
            # post-attach NAS procedures over the air (VERDICT r3 item 8)
            if sc.post_attach:
                self._post_attach_tti()
            self.tti += 1
            if all(len(ue.delivered_ip) >= ue.want_echoes
                   for ue in self.ues) and self._post_attach_done():
                break
        return self.summary(ip_payload)

    def _post_attach_done(self) -> bool:
        sc = self.sc
        if not sc.post_attach:
            return True
        if sc.post_attach == "detach":
            return all(u.nas.state == UeEmmState.DEREGISTERED
                       for u in self.ues)
        if sc.post_attach == "tau":
            return all(u.nas.tau_count >= 1 for u in self.ues)
        if sc.post_attach == "service_request":
            return all(u.post_started
                       and len(u.delivered_ip) >= u.want_echoes
                       for u in self.ues)
        if sc.post_attach == "dedicated_bearer":
            return all(u.post_started and u.delivered_voice
                       for u in self.ues)
        return True

    def _post_attach_tti(self) -> None:
        sc = self.sc
        for ue in self.ues:
            ready = (not ue.post_started and ue.delivered_ip
                     and ue.nas.state == UeEmmState.REGISTERED
                     and ue.crnti is not None
                     and ue.crnti in self.l2[ue.serving])
            if not ready:
                continue
            ue.post_started = True
            if sc.post_attach == "detach":
                ue.queue_srb1(UlInformationTransfer(
                    dedicated_info_nas=ue.nas.detach_request()).pack())
                self._ev(f"ue{ue.ue_id} NAS DetachRequest queued (SRB1)")
            elif sc.post_attach == "tau":
                ue.queue_srb1(UlInformationTransfer(
                    dedicated_info_nas=ue.nas.tau_request(tac=7)).pack())
                self._ev(f"ue{ue.ue_id} NAS TAU request queued (SRB1)")
            elif sc.post_attach == "dedicated_bearer":
                # network-initiated dedicated bearer: E-RAB Setup + NAS
                # activation ride S1 -> SRB1 -> the abstraction air
                app = self.enb_app[ue.serving]
                ctx = app.by_crnti.get(ue.crnti)
                if ctx is None:
                    ue.post_started = False
                    continue
                for pdu in self.mme.activate_dedicated_bearer(
                        ctx.mme_ue_id, qci=1, tft_dport=VOICE_PORT):
                    app.handle_mme_initiated(pdu)
                l2 = self.l2[ue.serving][ue.crnti]
                for nas in app.poll_nas(ue.crnti):
                    l2.queue_srb1(DlInformationTransfer(
                        dedicated_info_nas=nas).pack())
                self._ev(f"ue{ue.ue_id} dedicated-bearer activation "
                         "queued (E-RAB Setup + NAS over SRB1)")
            elif sc.post_attach == "service_request":
                # network releases the UE to ECM-IDLE, context kept
                app = self.enb_app[ue.serving]
                ctx = app.by_crnti.get(ue.crnti)
                if ctx is None:
                    ue.post_started = False
                    continue
                app._dispatch([self.mme.release(ctx.mme_ue_id,
                                                cause="idle")])
                self.enb_rrc[ue.serving].ues.pop(ue.crnti, None)
                self._ue_to_idle(ue)
                ue.want_echoes = 2
                self._ev(f"ue{ue.ue_id} released to ECM-IDLE "
                         "(context kept) -> will ServiceRequest")
        if sc.post_attach == "dedicated_bearer":
            self._dedicated_bearer_tti()

    def _dedicated_bearer_tti(self) -> None:
        """Drive the dedicated-bearer flow: once the UE accepted the NAS
        activation (nas.bearers non-empty), stand up DRB2 on both sides
        (the second DRB the reference's RRC reconfiguration would add)
        and run a voice echo over it — dport == the TFT port, so the SGW
        routes the PDN's response back over the DEDICATED tunnel."""
        import struct as _st
        for ue in self.ues:
            if not ue.post_started or not ue.nas.bearers:
                continue
            ebi = next(iter(ue.nas.bearers))
            if ue.drb2 is None:
                ue.drb2 = RlcUm()
                ue.pdcp2_ul = PdcpEntity(PdcpConfig(bearer=ebi,
                                                    ciphering="xor"))
                ue.pdcp2_dl = PdcpEntity(PdcpConfig(bearer=ebi,
                                                    ciphering="xor"))
                self._ev(f"ue{ue.ue_id} DRB2 up (EBI {ebi})")
            l2 = self.l2[ue.serving].get(ue.crnti)
            if l2 is not None and l2.drb2 is None:
                l2.drb2 = RlcUm()
                l2.pdcp2_dl = PdcpEntity(PdcpConfig(bearer=ebi,
                                                    ciphering="xor"))
                l2.pdcp2_ul = PdcpEntity(PdcpConfig(bearer=ebi,
                                                    ciphering="xor"))
            if l2 is None or l2.drb2 is None:
                continue
            if (not ue.voice_sent
                    or (not ue.delivered_voice
                        and self.tti - ue.voice_tti > 100)):
                ue.voice_sent = True
                ue.voice_tti = self.tti
                ip = bytearray(20)
                ip[0] = 0x45
                ip[9] = 17
                payload = b"voice-" + bytes([ue.ue_id])
                _st.pack_into(">H", ip, 2, 28 + len(payload))
                udp = _st.pack(">HHHH", VOICE_PORT, VOICE_PORT,
                               8 + len(payload), 0)
                pkt = bytes(ip) + udp + payload
                assert ue.nas.bearer_for_uplink(pkt) == ebi
                ue.drb2.tx_enqueue(ue.pdcp2_ul.data_req(pkt))
                self._ev(f"ue{ue.ue_id} queued voice packet (DRB2)")

    def summary(self, ip_payload: bytes) -> dict:
        registered = [ue.nas.state == UeEmmState.REGISTERED
                      for ue in self.ues]
        echoes = [bool(ue.delivered_ip
                       and ue.delivered_ip[0]
                       == ip_payload + bytes([ue.ue_id]))
                  for ue in self.ues]
        secured = [ue.srb_pdcp_tx.integrity_on
                   and ue.srb_pdcp_rx._rx_state == "on"
                   for ue in self.ues]
        mme_reg = sum(c.state == EmmState.REGISTERED
                      for c in self.mme.ues.values())
        return dict(
            ttis=self.tti,
            registered=registered,
            all_registered=all(registered),
            mme_registered=mme_reg,
            echoes=echoes,
            all_echoed=all(echoes),
            as_secured=secured,
            contention_losses=sum(u.contention_losses for u in self.ues),
            ra_attempts=sum(u.ra_attempts for u in self.ues),
            int_failures=sum(u.srb_pdcp_rx.int_failures for u in self.ues),
            stats=dict(self.stats),
            trace=list(self.trace))


def main():
    import argparse
    import json
    p = argparse.ArgumentParser(
        description="full-stack multi-UE oaisim (abstraction air)")
    p.add_argument("-u", "--n-ue", type=int, default=4)
    p.add_argument("-e", "--n-enb", type=int, default=1)
    p.add_argument("-s", "--snr", type=float, default=14.0)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    sim = OaisimFullStack(FullStackScenario(
        n_ue=a.n_ue, n_enb=a.n_enb, snr_db=a.snr, seed=a.seed))
    res = sim.run()
    res.pop("trace")
    print(json.dumps(res, indent=2, default=str))


if __name__ == "__main__":
    main()
