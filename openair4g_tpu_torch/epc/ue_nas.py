"""UE NAS (EMM/ESM) state machine.

Reference parity: openair-cn/NAS/EURECOM-NAS/src UE side — emm attach
procedure (emm/Attach.c), authentication response computation
(emm/Authentication.c), security mode (emm/SecurityModeControl.c), ESM
default-bearer accept (esm/DefaultEpsBearerContextActivation.c).

A copy of openair4g_tpu/epc/ue_nas.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from .nas import (AttachRequest, AuthenticationRequest,
                  AuthenticationResponse, SecurityModeCommand,
                  SecurityModeComplete, AttachAccept, AttachComplete,
                  ActivateDefaultBearerRequest, ActivateDefaultBearerAccept,
                  DetachRequest, DetachAccept, TrackingAreaUpdateRequest,
                  TrackingAreaUpdateAccept, TrackingAreaUpdateComplete,
                  ServiceRequest, IdentityRequest, IdentityResponse,
                  GutiReallocationCommand, GutiReallocationComplete,
                  EmmInformation, ActivateDedicatedBearerRequest,
                  ActivateDedicatedBearerAccept, DeactivateBearerRequest,
                  DeactivateBearerAccept, unpack_tft, decode_nas,
                  auth_vector)


class UeEmmState(Enum):
    DEREGISTERED = 0
    ATTACHING = 1
    REGISTERED = 2
    DETACHING = 3


class UeNas:
    def __init__(self, imsi: int, k: bytes):
        assert len(k) == 16
        self.imsi = imsi
        self.k = k
        self.state = UeEmmState.DEREGISTERED
        self.guti = 0
        self.ip = 0
        self.ebi = 0
        self.kasme = b""
        self.tac = 1
        self.network_name = b""
        self.tau_count = 0
        self.bearers: dict[int, dict] = {}   # dedicated: ebi -> params
        from .security import NasSecurityContext
        self.sec = NasSecurityContext()

    def attach_request(self) -> bytes:
        self.state = UeEmmState.ATTACHING
        return AttachRequest(imsi=self.imsi).pack()

    # ------------------------------------------ UE-initiated procedures --
    def _initial(self, msg) -> bytes:
        """Protect a UE-originated NAS message with the live context."""
        from .security import DIR_UPLINK
        out = msg.pack()
        return self.sec.protect(out, DIR_UPLINK) if self.sec.active else out

    def detach_request(self, switch_off: bool = False) -> bytes:
        """24.301 §5.5.2.2 UE-initiated detach (emm/Detach.c). Switch-off
        expects no DetachAccept — the UE deregisters locally."""
        assert self.state == UeEmmState.REGISTERED, self.state
        self.state = (UeEmmState.DEREGISTERED if switch_off
                      else UeEmmState.DETACHING)
        return self._initial(DetachRequest(
            guti=self.guti, detach_type=2 if switch_off else 1))

    def service_request(self) -> bytes:
        """§5.6.1: idle -> connected; EMM stays REGISTERED, the network
        re-establishes the S1 context + bearers."""
        assert self.state == UeEmmState.REGISTERED, self.state
        return self._initial(ServiceRequest(guti=self.guti))

    def tau_request(self, tac: int | None = None,
                    periodic: bool = False) -> bytes:
        """§5.5.3 tracking area update (emm/TrackingAreaUpdate.c)."""
        assert self.state == UeEmmState.REGISTERED, self.state
        return self._initial(TrackingAreaUpdateRequest(
            guti=self.guti, tac=self.tac if tac is None else tac,
            update_type=3 if periodic else 0))

    def handle_downlink(self, nas_pdu: bytes) -> bytes | None:
        """DL NAS in -> optional UL NAS out. Integrity: the first secured
        message (the SMC) activates the context from KASME with the
        algorithm IDs carried IN the SMC (24.301 §5.4.3.3: the UE reads
        the selected EIA/EEA from the plain inner message, derives the
        keys, then verifies the SMC's own MAC)."""
        from .security import SECURED_TAG, DIR_DOWNLINK, DIR_UPLINK
        from .nas import decode_nas, SecurityModeCommand
        if nas_pdu and nas_pdu[0] == SECURED_TAG and not self.sec.active:
            assert self.kasme, "secured NAS before authentication"
            smc = decode_nas(self.sec.peek(nas_pdu))
            assert isinstance(smc, SecurityModeCommand), smc
            self.sec.activate(self.kasme, eia=smc.eia, eea=smc.eea)
        nas_pdu = self.sec.unprotect(nas_pdu, DIR_DOWNLINK)
        out = self._handle_plain(nas_pdu)
        if out is not None:
            out = self.sec.protect(out, DIR_UPLINK)
        return out

    def _handle_plain(self, nas_pdu: bytes) -> bytes | None:
        msg = decode_nas(nas_pdu)
        if isinstance(msg, AuthenticationRequest):
            # recompute from (K, RAND); verify the network via AUTN
            autn, res, kasme = auth_vector(self.k, msg.rand)
            assert autn == msg.autn, "network authentication failed"
            self.kasme = kasme
            return AuthenticationResponse(res=res).pack()
        if isinstance(msg, SecurityModeCommand):
            return SecurityModeComplete().pack()
        if isinstance(msg, AttachAccept):
            esm = decode_nas(msg.esm_container)
            assert isinstance(esm, ActivateDefaultBearerRequest)
            self.guti = msg.guti
            self.ip = esm.pdn_ipv4
            self.ebi = esm.ebi
            self.state = UeEmmState.REGISTERED
            acc = ActivateDefaultBearerAccept(ebi=esm.ebi)
            return AttachComplete(esm_container=acc.pack()).pack()
        if isinstance(msg, DetachAccept):
            assert self.state == UeEmmState.DETACHING, self.state
            self.state = UeEmmState.DEREGISTERED
            self.ip = self.ebi = self.guti = 0
            return None
        if isinstance(msg, DetachRequest) and msg.network_originated:
            # network-initiated detach (§5.5.2.3): accept + deregister
            self.state = UeEmmState.DEREGISTERED
            self.ip = self.ebi = self.guti = 0
            return DetachAccept().pack()
        if isinstance(msg, TrackingAreaUpdateAccept):
            assert self.state == UeEmmState.REGISTERED, self.state
            self.guti = msg.guti          # GUTI reallocation folded in
            self.tac = msg.tac
            self.tau_count += 1
            return TrackingAreaUpdateComplete().pack()
        if isinstance(msg, IdentityRequest):
            assert msg.id_type == 1       # IMSI
            return IdentityResponse(imsi=self.imsi).pack()
        if isinstance(msg, GutiReallocationCommand):
            self.guti = msg.guti
            return GutiReallocationComplete().pack()
        if isinstance(msg, EmmInformation):
            self.network_name = msg.network_name
            return None
        if isinstance(msg, ActivateDedicatedBearerRequest):
            # esm/DedicatedEpsBearerContextActivation.c: record the TFT
            # + QoS against the new EBI, linked to the default bearer
            assert msg.linked_ebi == self.ebi, (msg.linked_ebi, self.ebi)
            self.bearers[msg.ebi] = dict(qci=msg.qci,
                                         tft_dport=unpack_tft(msg.tft),
                                         linked_ebi=msg.linked_ebi)
            return ActivateDedicatedBearerAccept(ebi=msg.ebi).pack()
        if isinstance(msg, DeactivateBearerRequest):
            self.bearers.pop(msg.ebi, None)
            return DeactivateBearerAccept(ebi=msg.ebi).pack()
        raise ValueError(f"unhandled DL NAS {msg}")

    def bearer_for_uplink(self, pkt: bytes) -> int:
        """UE-side UL TFT: an IPv4/UDP packet whose SOURCE port matches a
        dedicated bearer's service-flow port rides that bearer (the UL
        mirror of the DL filter); everything else takes the default
        bearer (24.301 §6.4.2 match-all on the default)."""
        if len(pkt) >= 28 and (pkt[0] >> 4) == 4 and pkt[9] == 17:
            ihl = (pkt[0] & 0xF) * 4
            sport = (pkt[ihl] << 8) | pkt[ihl + 1]
            for ebi, b in self.bearers.items():
                if b["tft_dport"] == sport:
                    return ebi
        return self.ebi
