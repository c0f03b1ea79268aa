"""MME-lite: S1AP endpoint + EMM attach state machine per UE.

Reference parity: openair-cn/MME_APP (UE context store, attach
orchestration), NAS/EURECOM-NAS/src/emm/sap (EMM state machine:
DEREGISTERED -> COMMON-PROCEDURE (auth, SMC) -> REGISTERED), S1AP MME
handlers (s1ap_mme_nas_procedures.c). The S11 interface to the SGW is a
direct object call (the reference's ITTI SGW_CREATE_SESSION_REQUEST /
MODIFY_BEARER messages).

Flow per UE (the ladder the integration test climbs):
  InitialUEMessage(AttachRequest)
    -> HSS auth vector -> DownlinkNASTransport(AuthenticationRequest)
  UplinkNASTransport(AuthenticationResponse)  [XRES check]
    -> DownlinkNASTransport(SecurityModeCommand)
  UplinkNASTransport(SecurityModeComplete)
    -> SGW create_session -> InitialContextSetupRequest(AttachAccept +
       ActivateDefaultBearerRequest, SGW UL TEID)
  InitialContextSetupResponse -> SGW modify_bearer (eNB DL TEID)
  UplinkNASTransport(AttachComplete(BearerAccept)) -> EMM-REGISTERED

A copy of openair4g_tpu/epc/mme.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from .nas import (AttachRequest, AuthenticationRequest,
                  AuthenticationResponse, SecurityModeCommand,
                  SecurityModeComplete, AttachAccept, AttachComplete,
                  ActivateDefaultBearerRequest, ActivateDefaultBearerAccept,
                  DetachRequest, DetachAccept, TrackingAreaUpdateRequest,
                  TrackingAreaUpdateAccept, TrackingAreaUpdateComplete,
                  ServiceRequest, IdentityRequest, IdentityResponse,
                  EmmInformation, ActivateDedicatedBearerRequest,
                  ActivateDedicatedBearerAccept, DeactivateBearerRequest,
                  DeactivateBearerAccept, pack_tft, decode_nas)
from .s1ap import (S1SetupRequest, S1SetupResponse, InitialUeMessage,
                   DownlinkNasTransport, UplinkNasTransport,
                   InitialContextSetupRequest, InitialContextSetupResponse,
                   UeContextReleaseCommand, UeContextReleaseComplete,
                   PathSwitchRequest, PathSwitchRequestAcknowledge,
                   ERabSetupRequest, ERabSetupResponse, ERabReleaseCommand,
                   decode_s1ap)
from .hss import Hss
from .sgw import SgwPgw
from .security import (NasSecurityContext, IntegrityError, DIR_UPLINK,
                       DIR_DOWNLINK)


class EmmState(Enum):
    DEREGISTERED = 0
    AUTH_PENDING = 1
    SMC_PENDING = 2
    CTX_PENDING = 3
    REGISTERED = 4


@dataclass
class MmeUeContext:
    mme_ue_id: int
    enb_ue_id: int
    imsi: int = 0
    state: EmmState = EmmState.DEREGISTERED
    xres: bytes = b""
    kasme: bytes = b""
    guti: int = 0
    tac: int = 1
    bearer = None
    sec: NasSecurityContext = field(default_factory=NasSecurityContext)
    dedicated: dict = field(default_factory=dict)   # ebi -> sgw Bearer
    ecm_idle: bool = False           # ECM state (S1 signalling conn up?)
    release_cause: str = "detach"    # what the pending release means
    detaching: bool = False          # DetachAccept sent, awaiting release


class Mme:
    def __init__(self, hss: Hss, sgw: SgwPgw, mme_group: int = 4,
                 mme_code: int = 1, eia: int = 2, eea: int = 2):
        self.hss = hss
        self.sgw = sgw
        self.mme_group = mme_group
        self.mme_code = mme_code
        self.eia, self.eea = eia, eea   # SMC algorithm selection (33.401)
        self.ues: dict[int, MmeUeContext] = {}
        self._next_id = 1
        self._next_mtmsi = 0xC0000001

    # ------------------------------------------------------- S1 endpoint --
    def handle_s1ap(self, pdu: bytes) -> list:
        """One S1AP PDU in -> list of S1AP PDUs out (the reference's SCTP
        stream, in-process)."""
        msg = decode_s1ap(pdu)
        if isinstance(msg, S1SetupRequest):
            return [S1SetupResponse(mme_group=self.mme_group,
                                    mme_code=self.mme_code).pack()]
        if isinstance(msg, InitialUeMessage):
            return self._initial_ue(msg)
        if isinstance(msg, UplinkNasTransport):
            return self._uplink_nas(msg)
        if isinstance(msg, InitialContextSetupResponse):
            ctx = self.ues[msg.mme_ue_id]
            self.sgw.modify_bearer(ctx.bearer.sgw_teid_ul,
                                   msg.enb_teid_dl, msg.enb_addr)
            return []
        if isinstance(msg, PathSwitchRequest):
            # X2 handover completion: re-point the S1-U downlink tunnel at
            # the target eNB (s1ap_mme handler -> SGW Modify Bearer)
            ctx = self.ues[msg.mme_ue_id]
            assert ctx.state == EmmState.REGISTERED, ctx.state
            self.sgw.modify_bearer(ctx.bearer.sgw_teid_ul,
                                   msg.enb_teid_dl, msg.enb_addr)
            ctx.enb_ue_id = msg.enb_ue_id
            return [PathSwitchRequestAcknowledge(
                mme_ue_id=msg.mme_ue_id, enb_ue_id=msg.enb_ue_id).pack()]
        if isinstance(msg, UeContextReleaseComplete):
            ctx = self.ues.get(msg.mme_ue_id)
            if ctx is None:
                return []
            if ctx.release_cause == "idle" and not ctx.detaching \
                    and ctx.state == EmmState.REGISTERED:
                # ECM-IDLE: keep the EMM context + session; only the S1
                # logical connection and the S1-U DL endpoint go away
                # (reference MME_APP keeps the UE REGISTERED; SGW gets
                # Release Access Bearers)
                ctx.ecm_idle = True
                if ctx.bearer is not None:
                    self.sgw.release_access_bearers(ctx.bearer.sgw_teid_ul)
            else:
                self.ues.pop(msg.mme_ue_id, None)
            return []
        if isinstance(msg, ERabSetupResponse):
            # dedicated E-RAB up at the eNB: complete the S1-U tunnel
            ctx = self.ues[msg.mme_ue_id]
            b = ctx.dedicated[msg.erab_id]
            self.sgw.modify_bearer(b.sgw_teid_ul, msg.enb_teid_dl,
                                   msg.enb_addr)
            return []
        raise ValueError(f"unhandled S1AP {msg}")

    # ------------------------------------------- dedicated bearers (ESM) --
    def activate_dedicated_bearer(self, mme_ue_id: int, qci: int = 1,
                                  tft_dport: int = 0) -> list:
        """Network-initiated dedicated bearer (24.301 §6.4.2, reference
        openair-cn NAS/.../ESM/DedicatedEpsBearerContextActivation.c):
        SGW Create Bearer -> S1AP E-RAB Setup carrying the NAS
        ActivateDedicatedEPSBearerContextRequest with the TFT."""
        ctx = self.ues[mme_ue_id]
        assert ctx.state == EmmState.REGISTERED, ctx.state
        ebi = max([5, *ctx.dedicated.keys()]) + 1
        b = self.sgw.create_dedicated_bearer(ctx.bearer.sgw_teid_ul, ebi,
                                             qci, tft_dport)
        ctx.dedicated[ebi] = b
        nas = ActivateDedicatedBearerRequest(
            ebi=ebi, linked_ebi=ctx.bearer.ebi, qci=qci,
            tft=pack_tft(tft_dport))
        return [ERabSetupRequest(
            mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id,
            erab_id=ebi, qci=qci, sgw_teid_ul=b.sgw_teid_ul,
            nas_pdu=ctx.sec.protect(nas.pack(), DIR_DOWNLINK)).pack()]

    def deactivate_dedicated_bearer(self, mme_ue_id: int,
                                    ebi: int) -> list:
        """Network-initiated dedicated-bearer release (24.301 §6.4.4):
        E-RAB Release + NAS DeactivateEPSBearerContextRequest."""
        ctx = self.ues[mme_ue_id]
        b = ctx.dedicated[ebi]
        self.sgw.delete_dedicated_bearer(b.sgw_teid_ul)
        nas = DeactivateBearerRequest(ebi=ebi)
        return [ERabReleaseCommand(
            mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id, erab_id=ebi,
            nas_pdu=ctx.sec.protect(nas.pack(), DIR_DOWNLINK)).pack()]

    # --------------------------------------------------------- procedures --
    def _ctx_by_guti(self, guti: int) -> MmeUeContext | None:
        for c in self.ues.values():
            if c.guti == guti:
                return c
        return None

    def _initial_ue(self, msg: InitialUeMessage) -> list:
        if msg.s_tmsi:
            # secured initial NAS from a known (idle) UE: ServiceRequest
            # or TrackingAreaUpdateRequest — find the context by S-TMSI,
            # verify integrity with its live security context
            ctx = self._ctx_by_guti(msg.s_tmsi)
            assert ctx is not None, f"unknown S-TMSI {msg.s_tmsi:#x}"
            try:
                plain = ctx.sec.unprotect(msg.nas_pdu, DIR_UPLINK)
            except IntegrityError:
                return []
            ctx.enb_ue_id = msg.enb_ue_id
            nas = decode_nas(plain)
            if isinstance(nas, ServiceRequest):
                return self._service_request(ctx)
            if isinstance(nas, TrackingAreaUpdateRequest):
                return self._tau(ctx, nas)
            raise ValueError(f"unhandled initial NAS {nas}")
        nas = decode_nas(msg.nas_pdu)
        assert isinstance(nas, AttachRequest), nas
        assert self.hss.known(nas.imsi), f"unknown IMSI {nas.imsi}"
        ctx = MmeUeContext(mme_ue_id=self._next_id,
                           enb_ue_id=msg.enb_ue_id, imsi=nas.imsi,
                           tac=msg.tac)
        self._next_id += 1
        self.ues[ctx.mme_ue_id] = ctx
        vec = self.hss.authentication_info(nas.imsi)
        ctx.xres, ctx.kasme = vec["xres"], vec["kasme"]
        ctx.state = EmmState.AUTH_PENDING
        auth = AuthenticationRequest(rand=vec["rand"], autn=vec["autn"])
        return [DownlinkNasTransport(mme_ue_id=ctx.mme_ue_id,
                                     enb_ue_id=ctx.enb_ue_id,
                                     nas_pdu=auth.pack()).pack()]

    def _service_request(self, ctx: MmeUeContext) -> list:
        """§5.6.1: re-establish the S1 context + E-RAB for an idle UE
        (the InitialContextSetupRequest IS the accept)."""
        assert ctx.state == EmmState.REGISTERED, ctx.state
        ctx.ecm_idle = False
        from .security import derive_k_enb
        return [InitialContextSetupRequest(
            mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id,
            erab_id=ctx.bearer.ebi, sgw_teid_ul=ctx.bearer.sgw_teid_ul,
            security_key=derive_k_enb(ctx.kasme)).pack()]

    def _tau(self, ctx: MmeUeContext, nas: TrackingAreaUpdateRequest) -> list:
        """§5.5.3: update the TA, reallocate the GUTI (the reference MME
        folds GUTI reallocation into the TAU accept)."""
        assert ctx.state == EmmState.REGISTERED, ctx.state
        ctx.tac = nas.tac
        ctx.guti = ((self.mme_group << 40) | (self.mme_code << 32)
                    | self._next_mtmsi)
        self._next_mtmsi += 1
        ctx.ecm_idle = False
        acc = TrackingAreaUpdateAccept(guti=ctx.guti, tac=ctx.tac)
        return [DownlinkNasTransport(
            mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id,
            nas_pdu=ctx.sec.protect(acc.pack(), DIR_DOWNLINK)).pack()]

    def _uplink_nas(self, msg: UplinkNasTransport) -> list:
        ctx = self.ues[msg.mme_ue_id]
        try:
            plain = ctx.sec.unprotect(msg.nas_pdu, DIR_UPLINK)
        except IntegrityError:
            return []                  # reference: discard on MAC failure
        nas = decode_nas(plain)
        if isinstance(nas, AuthenticationResponse):
            assert ctx.state == EmmState.AUTH_PENDING, ctx.state
            assert nas.res == ctx.xres, "authentication failure (RES!=XRES)"
            ctx.state = EmmState.SMC_PENDING
            # NAS security activates with the SMC: the command itself is
            # integrity-protected with the new context (nas_message.c)
            ctx.sec.activate(ctx.kasme, eia=self.eia, eea=self.eea)
            return [DownlinkNasTransport(
                mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id,
                nas_pdu=ctx.sec.protect(
                    SecurityModeCommand(eea=self.eea, eia=self.eia).pack(),
                    DIR_DOWNLINK, cipher=False)).pack()]
        if isinstance(nas, SecurityModeComplete):
            assert ctx.state == EmmState.SMC_PENDING, ctx.state
            ctx.state = EmmState.CTX_PENDING
            ctx.bearer = self.sgw.create_session(ctx.imsi, ebi=5)
            ctx.guti = ((self.mme_group << 40) | (self.mme_code << 32)
                        | self._next_mtmsi)
            self._next_mtmsi += 1
            esm = ActivateDefaultBearerRequest(
                ebi=5, pdn_ipv4=ctx.bearer.ue_ipv4)
            accept = AttachAccept(guti=ctx.guti, esm_container=esm.pack())
            from .security import derive_k_enb
            return [InitialContextSetupRequest(
                mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id,
                erab_id=5, sgw_teid_ul=ctx.bearer.sgw_teid_ul,
                nas_pdu=ctx.sec.protect(accept.pack(),
                                        DIR_DOWNLINK),
                security_key=derive_k_enb(ctx.kasme)).pack()]
        if isinstance(nas, AttachComplete):
            assert ctx.state == EmmState.CTX_PENDING, ctx.state
            acc = decode_nas(nas.esm_container)
            assert isinstance(acc, ActivateDefaultBearerAccept)
            assert acc.ebi == 5
            ctx.state = EmmState.REGISTERED
            return []
        if isinstance(nas, DetachRequest):
            # UE-initiated detach (§5.5.2.2, NAS/MME/EMM/Detach.c):
            # delete the session, accept (unless switch-off), release S1
            if ctx.bearer is not None:
                self.sgw.delete_session(ctx.bearer.sgw_teid_ul)
                ctx.bearer = None
            ctx.detaching = True
            ctx.state = EmmState.DEREGISTERED
            out = []
            if nas.detach_type != 2:          # not switch-off
                out.append(DownlinkNasTransport(
                    mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id,
                    nas_pdu=ctx.sec.protect(DetachAccept().pack(),
                                            DIR_DOWNLINK)).pack())
            out.append(UeContextReleaseCommand(
                mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id).pack())
            return out
        if isinstance(nas, TrackingAreaUpdateRequest):
            # connected-mode TAU (no new S1 connection)
            return self._tau(ctx, nas)
        if isinstance(nas, TrackingAreaUpdateComplete):
            return []
        if isinstance(nas, DetachAccept):
            # network-initiated detach confirmed: release the S1 context
            return [UeContextReleaseCommand(
                mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id).pack()]
        if isinstance(nas, IdentityResponse):
            # identification procedure answer (emm/Identification.c)
            assert nas.imsi == ctx.imsi, (nas.imsi, ctx.imsi)
            return []
        if isinstance(nas, ActivateDedicatedBearerAccept):
            assert nas.ebi in ctx.dedicated, nas.ebi
            return []
        if isinstance(nas, DeactivateBearerAccept):
            ctx.dedicated.pop(nas.ebi, None)
            return []
        raise ValueError(f"unhandled NAS {nas}")

    def release(self, mme_ue_id: int, cause: str = "detach") -> bytes:
        """cause='detach' removes the context on completion; 'idle' keeps
        the EMM context (ECM-IDLE) so paging / service request work."""
        ctx = self.ues[mme_ue_id]
        ctx.release_cause = cause
        return UeContextReleaseCommand(mme_ue_id=ctx.mme_ue_id,
                                       enb_ue_id=ctx.enb_ue_id).pack()

    def detach(self, mme_ue_id: int) -> list:
        """Network-initiated detach (§5.5.2.3): DetachRequest toward the
        UE, then context release once the accept comes back."""
        ctx = self.ues[mme_ue_id]
        if ctx.bearer is not None:
            self.sgw.delete_session(ctx.bearer.sgw_teid_ul)
            ctx.bearer = None
        ctx.detaching = True
        ctx.state = EmmState.DEREGISTERED
        req = DetachRequest(guti=ctx.guti, network_originated=1)
        return [DownlinkNasTransport(
            mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id,
            nas_pdu=ctx.sec.protect(req.pack(), DIR_DOWNLINK)).pack()]

    def identity_request(self, mme_ue_id: int) -> bytes:
        """Start the identification procedure (IMSI query)."""
        ctx = self.ues[mme_ue_id]
        req = IdentityRequest(id_type=1)
        pdu = (ctx.sec.protect(req.pack(), DIR_DOWNLINK)
               if ctx.sec.active else req.pack())
        return DownlinkNasTransport(mme_ue_id=ctx.mme_ue_id,
                                    enb_ue_id=ctx.enb_ue_id,
                                    nas_pdu=pdu).pack()

    def emm_information(self, mme_ue_id: int, network_name: bytes) -> bytes:
        """EMM INFORMATION toward a registered UE — also the >255-byte
        DL NAS payload that exercises RLC-AM segmentation end-to-end."""
        ctx = self.ues[mme_ue_id]
        msg = EmmInformation(network_name=network_name)
        return DownlinkNasTransport(
            mme_ue_id=ctx.mme_ue_id, enb_ue_id=ctx.enb_ue_id,
            nas_pdu=ctx.sec.protect(msg.pack(), DIR_DOWNLINK)).pack()

    def page(self, imsi: int) -> bytes:
        """Mobile-terminated traffic for an idle UE -> S1AP Paging toward
        every eNB in the tracking area (s1ap_mme paging procedure)."""
        from .s1ap import S1apPaging
        assert self.hss.known(imsi), imsi
        return S1apPaging(ue_paging_id=imsi).pack()
