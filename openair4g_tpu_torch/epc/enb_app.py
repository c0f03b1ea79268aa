"""eNB application glue: RRC <-> S1AP <-> GTP-U (the reference's enb_app
+ s1ap_eNB tasks).

Reference parity: openair-cn usage from the eNB side —
s1ap_eNB_nas_procedures.c (wrap first NAS into InitialUEMessage, forward
DL NAS to RRC DLInformationTransfer, UL NAS to UplinkNASTransport) and
GTPV1-U on the eNB (per-bearer DL TEID allocation, PDCP <-> S1-U
forwarding the reference does in openair2 gtpv1u hooks).

A copy of openair4g_tpu/epc/enb_app.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .s1ap import (S1SetupRequest, InitialUeMessage, DownlinkNasTransport,
                   UplinkNasTransport, InitialContextSetupRequest,
                   InitialContextSetupResponse, UeContextReleaseCommand,
                   UeContextReleaseComplete, PathSwitchRequest,
                   PathSwitchRequestAcknowledge, ERabSetupRequest,
                   ERabSetupResponse, ERabReleaseCommand, decode_s1ap)
from .gtpu import gtpu_encap, gtpu_decap, GTPU_GPDU


@dataclass
class EnbUeS1Context:
    enb_ue_id: int
    crnti: int
    mme_ue_id: int = 0
    erab_id: int = 0
    sgw_teid_ul: int = 0      # uplink tunnel (allocated by SGW)
    enb_teid_dl: int = 0      # downlink tunnel (we allocate)
    pending_nas: list = field(default_factory=list)   # NAS for the UE
    security_key: bytes = b""  # K_eNB from InitialContextSetupRequest
    erabs: dict = field(default_factory=dict)  # ebi -> (sgw_ul, enb_dl)


class EnbApp:
    """One eNB's S1 interface. `mme` is the Mme object (in-process SCTP);
    `sgw` the SgwPgw (in-process S1-U).

    `pending_pages`: ue_paging_ids from S1AP Paging, drained by the
    RRC/MAC scheduler which transmits the PCCH Paging message at the UE's
    paging occasion (rrc/paging.py)."""

    def __init__(self, mme, sgw, enb_id: int = 0x19B, addr: int = 0x0A000002,
                 msc=None, pcap=None):
        """msc: optional utils.msc.Msc — records every S1AP/NAS exchange
        (the reference's MSC generator); pcap: optional utils.opt.PcapWriter
        — captures NAS and user-plane PDUs (the OPT packet tracer)."""
        self.mme = mme
        self.sgw = sgw
        self.msc = msc
        self.pcap = pcap
        self.enb_id = enb_id
        self.addr = addr
        self.by_crnti: dict[int, EnbUeS1Context] = {}
        self.by_enb_ue_id: dict[int, EnbUeS1Context] = {}
        self.by_teid: dict[int, EnbUeS1Context] = {}
        self._next_ue_id = 1
        # DL TEIDs are eNB-allocated: offset by enb_id so eNBs sharing
        # one SGW never collide (32-bit TEID space, 36.413 §9.2.2.1)
        self._next_teid = 0x2000 + ((enb_id & 0xFFFF) << 16)
        self.pending_pages: list[int] = []
        self._parting_nas: dict[int, list] = {}
        self.s1_up = False
        self._s1_setup()

    def handle_mme_initiated(self, pdu: bytes) -> None:
        """MME-initiated S1AP (Paging, context release) pushed to the
        eNB outside a request/response pair."""
        from .s1ap import S1apPaging
        msg = decode_s1ap(pdu)
        if isinstance(msg, S1apPaging):
            self._mrec("MME", "eNB", "S1AP Paging")
            self.pending_pages.append(msg.ue_paging_id)
        else:
            self._dispatch([pdu])

    def _mrec(self, src, dst, label):
        if self.msc is not None:
            self.msc.record(src, dst, label)

    def _s1_setup(self):
        self._mrec("eNB", "MME", "S1SetupRequest")
        for pdu in self.mme.handle_s1ap(
                S1SetupRequest(enb_id=self.enb_id).pack()):
            decode_s1ap(pdu)            # S1SetupResponse
            self._mrec("MME", "eNB", "S1SetupResponse")
        self.s1_up = True

    # ------------------------------------------------------ NAS transport --
    def initial_ue_message(self, crnti: int, nas_pdu: bytes,
                           s_tmsi: int = 0) -> None:
        """First NAS from a newly RRC-connected UE (rides
        RRCConnectionSetupComplete's dedicatedInfoNAS in the reference).
        `s_tmsi` != 0 identifies a returning idle UE (ServiceRequest /
        TAU) so the MME can find its live security context."""
        ctx = EnbUeS1Context(enb_ue_id=self._next_ue_id, crnti=crnti)
        self._next_ue_id += 1
        self.by_crnti[crnti] = ctx
        self.by_enb_ue_id[ctx.enb_ue_id] = ctx
        self._mrec("eNB", "MME", "InitialUEMessage")
        if self.pcap is not None:
            from ..utils.opt import KIND_NAS, DIR_UL
            self.pcap.write(nas_pdu, kind=KIND_NAS, direction=DIR_UL,
                            rnti=crnti)
        self._dispatch(self.mme.handle_s1ap(
            InitialUeMessage(enb_ue_id=ctx.enb_ue_id,
                             nas_pdu=nas_pdu, s_tmsi=s_tmsi).pack()))

    def uplink_nas(self, crnti: int, nas_pdu: bytes) -> None:
        ctx = self.by_crnti[crnti]
        self._mrec("eNB", "MME", "UplinkNASTransport")
        if self.pcap is not None:
            from ..utils.opt import KIND_NAS, DIR_UL
            self.pcap.write(nas_pdu, kind=KIND_NAS, direction=DIR_UL,
                            rnti=crnti)
        self._dispatch(self.mme.handle_s1ap(
            UplinkNasTransport(mme_ue_id=ctx.mme_ue_id,
                               enb_ue_id=ctx.enb_ue_id,
                               nas_pdu=nas_pdu).pack()))

    def poll_nas(self, crnti: int) -> list:
        """Drain NAS PDUs queued for a UE (RRC DLInformationTransfer /
        the AttachAccept inside RRCConnectionReconfiguration). NAS that
        was in flight when the UE context released (e.g. the
        DetachAccept) is delivered from the parting buffer — the real
        eNB sends it before RRCConnectionRelease."""
        ctx = self.by_crnti.get(crnti)
        if ctx is None:
            return self._parting_nas.pop(crnti, [])
        out = ctx.pending_nas
        ctx.pending_nas = []
        return out

    def _dispatch(self, pdus: list) -> None:
        for pdu in pdus:
            msg = decode_s1ap(pdu)
            if isinstance(msg, DownlinkNasTransport):
                self._mrec("MME", "eNB", "DownlinkNASTransport")
                ctx = self.by_enb_ue_id[msg.enb_ue_id]
                ctx.mme_ue_id = msg.mme_ue_id
                ctx.pending_nas.append(msg.nas_pdu)
            elif isinstance(msg, InitialContextSetupRequest):
                self._mrec("MME", "eNB", "InitialContextSetupRequest")
                self._mrec("eNB", "MME", "InitialContextSetupResponse")
                ctx = self.by_enb_ue_id[msg.enb_ue_id]
                ctx.mme_ue_id = msg.mme_ue_id
                ctx.erab_id = msg.erab_id
                ctx.sgw_teid_ul = msg.sgw_teid_ul
                ctx.security_key = msg.security_key
                ctx.enb_teid_dl = self._next_teid
                self._next_teid += 1
                self.by_teid[ctx.enb_teid_dl] = ctx
                if msg.nas_pdu:     # empty on service-request context
                    ctx.pending_nas.append(msg.nas_pdu)    # re-setup
                self._dispatch(self.mme.handle_s1ap(
                    InitialContextSetupResponse(
                        mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id,
                        erab_id=ctx.erab_id, enb_teid_dl=ctx.enb_teid_dl,
                        enb_addr=self.addr).pack()))
            elif isinstance(msg, ERabSetupRequest):
                self._mrec("MME", "eNB", "E-RABSetupRequest")
                ctx = self.by_enb_ue_id[msg.enb_ue_id]
                teid = self._next_teid
                self._next_teid += 1
                ctx.erabs[msg.erab_id] = (msg.sgw_teid_ul, teid)
                self.by_teid[teid] = ctx
                if msg.nas_pdu:
                    ctx.pending_nas.append(msg.nas_pdu)
                self._mrec("eNB", "MME", "E-RABSetupResponse")
                self._dispatch(self.mme.handle_s1ap(ERabSetupResponse(
                    mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id,
                    erab_id=msg.erab_id, enb_teid_dl=teid,
                    enb_addr=self.addr).pack()))
            elif isinstance(msg, ERabReleaseCommand):
                self._mrec("MME", "eNB", "E-RABReleaseCommand")
                ctx = self.by_enb_ue_id[msg.enb_ue_id]
                tun = ctx.erabs.pop(msg.erab_id, None)
                if tun is not None:
                    self.by_teid.pop(tun[1], None)
                if msg.nas_pdu:
                    ctx.pending_nas.append(msg.nas_pdu)
            elif isinstance(msg, UeContextReleaseCommand):
                ctx = self.by_enb_ue_id.pop(msg.enb_ue_id)
                self.by_crnti.pop(ctx.crnti, None)
                self.by_teid.pop(ctx.enb_teid_dl, None)
                for _, dl in ctx.erabs.values():
                    self.by_teid.pop(dl, None)
                if ctx.pending_nas:
                    self._parting_nas.setdefault(ctx.crnti, []).extend(
                        ctx.pending_nas)
                self._dispatch(self.mme.handle_s1ap(
                    UeContextReleaseComplete(
                        mme_ue_id=msg.mme_ue_id,
                        enb_ue_id=msg.enb_ue_id).pack()))
            else:
                raise ValueError(f"unhandled S1AP at eNB: {msg}")

    # ---------------------------------------------------------- handover --
    def handover_out(self, crnti: int) -> dict:
        """Source-eNB side of an X2 handover: hand the S1 context to the
        target and forget the local bindings (the path stays on this eNB
        until the target's PathSwitchRequest lands)."""
        ctx = self.by_crnti.pop(crnti)
        self.by_enb_ue_id.pop(ctx.enb_ue_id, None)
        self.by_teid.pop(ctx.enb_teid_dl, None)
        self._mrec("eNB", "eNB2", "X2 HandoverRequest(S1 context)")
        return dict(mme_ue_id=ctx.mme_ue_id, erab_id=ctx.erab_id,
                    sgw_teid_ul=ctx.sgw_teid_ul)

    def handover_in(self, crnti: int, s1_ctx: dict) -> None:
        """Target-eNB side: adopt the context, allocate a fresh DL TEID and
        switch the S1-U path (PathSwitchRequest -> MME -> SGW Modify
        Bearer, s1ap_eNB x2 handover flow)."""
        ctx = EnbUeS1Context(enb_ue_id=self._next_ue_id, crnti=crnti,
                             mme_ue_id=s1_ctx["mme_ue_id"],
                             erab_id=s1_ctx["erab_id"],
                             sgw_teid_ul=s1_ctx["sgw_teid_ul"],
                             enb_teid_dl=self._next_teid)
        self._next_ue_id += 1
        self._next_teid += 1
        self.by_crnti[crnti] = ctx
        self.by_enb_ue_id[ctx.enb_ue_id] = ctx
        self.by_teid[ctx.enb_teid_dl] = ctx
        self._mrec("eNB", "MME", "PathSwitchRequest")
        for pdu in self.mme.handle_s1ap(PathSwitchRequest(
                mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id,
                erab_id=ctx.erab_id, enb_teid_dl=ctx.enb_teid_dl,
                enb_addr=self.addr).pack()):
            ack = decode_s1ap(pdu)
            assert isinstance(ack, PathSwitchRequestAcknowledge)
            self._mrec("MME", "eNB", "PathSwitchRequestAcknowledge")

    # -------------------------------------------------------- user plane --
    def uplink_user(self, crnti: int, ip_pkt: bytes,
                    ebi: int | None = None) -> None:
        """PDCP SDU from the UE's DRB -> GTP-U toward the SGW. `ebi`
        selects a dedicated bearer's tunnel (default: the default
        bearer)."""
        ctx = self.by_crnti[crnti]
        teid = ctx.sgw_teid_ul if ebi is None or ebi not in ctx.erabs \
            else ctx.erabs[ebi][0]
        assert teid, "bearer not established"
        if self.pcap is not None:
            from ..utils.opt import KIND_IP, DIR_UL
            self.pcap.write(ip_pkt, kind=KIND_IP, direction=DIR_UL,
                            rnti=crnti)
        self._mrec("eNB", "SGW", "GTP-U G-PDU (UL)")
        resp = self.sgw.handle_uplink(gtpu_encap(teid, ip_pkt))
        assert resp is None

    def poll_downlink_user(self) -> list:
        """Drain OUR tunnels from the SGW downlink queue ->
        [(crnti, ip_pkt)] for PDCP DL; PDUs addressed to another eNB's
        TEIDs stay queued (several eNBs share one SGW)."""
        return [(crnti, pkt)
                for crnti, _, pkt in self.poll_downlink_user_bearers()]

    def poll_downlink_user_bearers(self) -> list:
        """As poll_downlink_user but bearer-aware:
        [(crnti, ebi, ip_pkt)] — ebi identifies which E-RAB's tunnel the
        PDU arrived on (the default bearer's erab_id, or a dedicated
        EBI), so L2 can map it to the right DRB."""
        out, keep = [], []
        for pdu in self.sgw.dl_queue:
            msg_type, teid, payload = gtpu_decap(pdu)
            assert msg_type == GTPU_GPDU
            ctx = self.by_teid.get(teid)
            if ctx is None:
                keep.append(pdu)
                continue
            ebi = ctx.erab_id
            for e, (_, dl) in ctx.erabs.items():
                if dl == teid:
                    ebi = e
                    break
            out.append((ctx.crnti, ebi, payload))
        self.sgw.requeue_unclaimed(keep)
        return out
