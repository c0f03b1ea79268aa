"""S1AP procedure set (36.413 subset), eNB <-> MME control plane.

Reference parity: openair-cn/S1AP — s1ap_eNB.c (S1 Setup),
s1ap_eNB_nas_procedures.c (InitialUEMessage, Uplink/DownlinkNASTransport),
s1ap_mme_nas_procedures.c, s1ap_eNB_handlers.c (InitialContextSetup ->
E-RAB + NAS delivery), s1ap_eNB_context_management_procedures.c (UE
context release). Same PER-lite byte codec convention as epc/nas.py; the
NAS PDU rides as an opaque length-prefixed container exactly like the
reference's NAS-PDU IE.

A copy of openair4g_tpu/epc/s1ap.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields

from .nas import _Writer, _Reader   # shared codec primitives

_REGISTRY: dict[int, type] = {}


def _s1ap_message(tag: int):
    def wrap(cls):
        cls.TAG = tag
        _REGISTRY[tag] = cls

        def pack(self) -> bytes:
            w = _Writer()
            w.put(tag, 1)
            for f in fields(self):
                v = getattr(self, f.name)
                if f.type in ("bytes", bytes):
                    # wide (2-byte) length: S1AP NAS-PDU / TransparentContainer
                    # OCTET STRINGs routinely exceed 255 bytes (36.413)
                    w.put_bytes(v, f.metadata.get("fixed"), wide=True)
                else:
                    w.put(int(v), f.metadata.get("width", 4))
            return bytes(w.out)

        @classmethod
        def unpack(kls, data: bytes):
            r = _Reader(data)
            t = r.take(1)
            assert t == tag, (t, tag)
            vals = {}
            for f in fields(kls):
                if f.type in ("bytes", bytes):
                    vals[f.name] = r.take_bytes(f.metadata.get("fixed"),
                                                wide=True)
                else:
                    vals[f.name] = r.take(f.metadata.get("width", 4))
            return kls(**vals)

        cls.pack = pack
        cls.unpack = unpack
        return cls
    return wrap


def decode_s1ap(data: bytes):
    return _REGISTRY[data[0]].unpack(data)


def _f(width: int = 4, **kw):
    return field(metadata={"width": width}, **kw)


def _fb(default: bytes = b""):
    return field(default=default, metadata={})


@_s1ap_message(0x01)
@dataclass
class S1SetupRequest:
    enb_id: int = _f(4)
    tac: int = _f(2, default=1)
    plmn: int = _f(3, default=0x02F829)          # 208.92 test PLMN


@_s1ap_message(0x02)
@dataclass
class S1SetupResponse:
    mme_group: int = _f(2, default=4)
    mme_code: int = _f(1, default=1)
    relative_capacity: int = _f(1, default=50)


@_s1ap_message(0x10)
@dataclass
class InitialUeMessage:
    enb_ue_id: int = _f(4)
    tac: int = _f(2, default=1)
    nas_pdu: bytes = _fb()
    s_tmsi: int = _f(8, default=0)   # optional S-TMSI IE (36.413
    #   §9.1.7.1): lets the MME find the existing security context for
    #   secured initial NAS (ServiceRequest / TAU); 0 = absent


@_s1ap_message(0x11)
@dataclass
class DownlinkNasTransport:
    mme_ue_id: int = _f(4)
    enb_ue_id: int = _f(4)
    nas_pdu: bytes = _fb()


@_s1ap_message(0x12)
@dataclass
class UplinkNasTransport:
    mme_ue_id: int = _f(4)
    enb_ue_id: int = _f(4)
    nas_pdu: bytes = _fb()


@_s1ap_message(0x20)
@dataclass
class InitialContextSetupRequest:
    """E-RAB to set up: uplink GTP TEID + transport address at the SGW,
    plus the piggybacked NAS (AttachAccept). 36.413 §8.3.1."""
    mme_ue_id: int = _f(4)
    enb_ue_id: int = _f(4)
    erab_id: int = _f(1, default=5)
    qci: int = _f(1, default=9)
    sgw_teid_ul: int = _f(4, default=0)
    sgw_addr: int = _f(4, default=0x0A000001)
    nas_pdu: bytes = _fb()
    security_key: bytes = _fb()    # K_eNB (36.413 SecurityKey IE) — the
    #   AS root key the eNB derives K_RRCint from (33.401 §A.7)


@_s1ap_message(0x21)
@dataclass
class InitialContextSetupResponse:
    mme_ue_id: int = _f(4)
    enb_ue_id: int = _f(4)
    erab_id: int = _f(1, default=5)
    enb_teid_dl: int = _f(4, default=0)
    enb_addr: int = _f(4, default=0x0A000002)


@_s1ap_message(0x22)
@dataclass
class ERabSetupRequest:
    """Dedicated E-RAB setup (36.413 §8.2.1): new E-RAB id + SGW uplink
    tunnel + the piggybacked NAS ActivateDedicatedBearerRequest."""
    mme_ue_id: int = _f(4)
    enb_ue_id: int = _f(4)
    erab_id: int = _f(1)
    qci: int = _f(1, default=1)
    sgw_teid_ul: int = _f(4, default=0)
    sgw_addr: int = _f(4, default=0x0A000001)
    nas_pdu: bytes = _fb()


@_s1ap_message(0x23)
@dataclass
class ERabSetupResponse:
    mme_ue_id: int = _f(4)
    enb_ue_id: int = _f(4)
    erab_id: int = _f(1)
    enb_teid_dl: int = _f(4, default=0)
    enb_addr: int = _f(4, default=0x0A000002)


@_s1ap_message(0x24)
@dataclass
class ERabReleaseCommand:
    """36.413 §8.2.3: tear one dedicated E-RAB down (+ piggybacked NAS
    DeactivateBearerRequest)."""
    mme_ue_id: int = _f(4)
    enb_ue_id: int = _f(4)
    erab_id: int = _f(1)
    nas_pdu: bytes = _fb()


@_s1ap_message(0x40)
@dataclass
class PathSwitchRequest:
    """X2-handover completion toward the EPC (36.413 §8.4.4): the target
    eNB asks the MME to switch the S1-U downlink to its own endpoint."""
    mme_ue_id: int = _f(4)
    enb_ue_id: int = _f(4)            # target-eNB UE id
    erab_id: int = _f(1, default=5)
    enb_teid_dl: int = _f(4, default=0)
    enb_addr: int = _f(4, default=0x0A000003)


@_s1ap_message(0x41)
@dataclass
class PathSwitchRequestAcknowledge:
    mme_ue_id: int = _f(4)
    enb_ue_id: int = _f(4)


@_s1ap_message(0x50)
@dataclass
class S1apPaging:
    """MME -> eNB Paging (36.413 §8.5): the eNB pages the UE at its
    paging occasion with P-RNTI DCI 1C."""
    ue_paging_id: int = _f(8)          # IMSI-based (packed as int here)
    tac: int = _f(2, default=1)
    cn_domain: int = _f(1, default=1)  # 1 = PS
    paging_drx: int = _f(1, default=1)


@_s1ap_message(0x30)
@dataclass
class UeContextReleaseCommand:
    mme_ue_id: int = _f(4)
    enb_ue_id: int = _f(4)
    cause: int = _f(1, default=0)


@_s1ap_message(0x31)
@dataclass
class UeContextReleaseComplete:
    mme_ue_id: int = _f(4)
    enb_ue_id: int = _f(4)
