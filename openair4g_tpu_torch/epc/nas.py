"""NAS EMM/ESM message set (24.301 subset) with a deterministic byte codec.

Reference parity: openair-cn/NAS/EURECOM-NAS/src/emm/msg (AttachRequest,
AuthenticationRequest/Response, SecurityModeCommand/Complete, AttachAccept,
AttachComplete) and /esm/msg (ActivateDefaultEPSBearerContextRequest/
Accept). The reference carries full 24.301 TLV encoding; this framework
carries the same IEs through the PER-lite convention used by
rrc/messages.py: one tag byte, then fixed-width fields MSB-first.

Security: the reference's Milenage/EEA/EIA (openair-cn/SECU) is replaced
by a deterministic SHA-256 derivation — same protocol shape (RAND/AUTN
challenge, XRES comparison, KASME -> NAS keys, ciphering hook), documented
non-cryptographic stand-in.

A copy of openair4g_tpu/epc/nas.py.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, fields

import numpy as np

_REGISTRY: dict[int, type] = {}


class _Writer:
    def __init__(self):
        self.out = bytearray()

    def put(self, val: int, width_bytes: int):
        assert 0 <= val < (1 << (8 * width_bytes)), (val, width_bytes)
        self.out += int(val).to_bytes(width_bytes, "big")

    def put_bytes(self, b: bytes, fixed: int | None = None,
                  wide: bool = False):
        if wide:                        # 2-byte length (LV-E, 24.301 IEs
            assert len(b) < (1 << 16)   # like the ESM message container)
            self.out += bytes([len(b) >> 8, len(b) & 0xFF])
            self.out += b
        elif fixed is None:
            assert len(b) < 256
            self.out.append(len(b))
            self.out += b
        else:
            assert len(b) == fixed
            self.out += b


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, width_bytes: int) -> int:
        v = int.from_bytes(self.data[self.pos:self.pos + width_bytes], "big")
        self.pos += width_bytes
        return v

    def take_bytes(self, fixed: int | None = None,
                   wide: bool = False) -> bytes:
        if wide:
            n = (self.data[self.pos] << 8) | self.data[self.pos + 1]
            self.pos += 2
        elif fixed is None:
            n = self.data[self.pos]
            self.pos += 1
        else:
            n = fixed
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(b)


def _nas_message(tag: int):
    """Dataclass codec: int fields use metadata width (bytes); bytes fields
    are length-prefixed unless metadata gives a fixed size."""
    def wrap(cls):
        cls.TAG = tag
        _REGISTRY[tag] = cls

        def pack(self) -> bytes:
            w = _Writer()
            w.put(tag, 1)
            for f in fields(self):
                v = getattr(self, f.name)
                if f.type in ("bytes", bytes):
                    w.put_bytes(v, f.metadata.get("fixed"),
                                f.metadata.get("wide", False))
                else:
                    w.put(int(v), f.metadata.get("width", 2))
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
                                                f.metadata.get("wide",
                                                               False))
                else:
                    vals[f.name] = r.take(f.metadata.get("width", 2))
            return kls(**vals)

        cls.pack = pack
        cls.unpack = unpack
        return cls
    return wrap


def decode_nas(data: bytes):
    cls = _REGISTRY[data[0]]
    return cls.unpack(data)


def _f(width: int = 2, **kw):
    return field(metadata={"width": width}, **kw)


def _fb(fixed: int | None = None, default: bytes = b""):
    return field(default=default, metadata={"fixed": fixed})


def _fbw(default: bytes = b""):
    """Wide (2-byte-length) bytes field — LV-E containers that can exceed
    255 bytes (24.301 ESM message container / EMM information text)."""
    return field(default=default, metadata={"wide": True})


# ------------------------------------------------------------------ EMM --

@_nas_message(0x41)
@dataclass
class AttachRequest:
    """24.301 §8.2.4: EPS attach type + identity (IMSI) + UE capability."""
    imsi: int = field(metadata={"width": 8})
    attach_type: int = _f(1, default=1)          # 1 = EPS attach
    ue_network_capability: int = _f(2, default=0xF0F0)


@_nas_message(0x52)
@dataclass
class AuthenticationRequest:
    """§8.2.7: RAND + AUTN challenge."""
    rand: bytes = _fb(16)
    autn: bytes = _fb(16)
    ksi: int = _f(1, default=0)


@_nas_message(0x53)
@dataclass
class AuthenticationResponse:
    res: bytes = _fb(8)


@_nas_message(0x5D)
@dataclass
class SecurityModeCommand:
    eea: int = _f(1, default=0)                   # selected ciphering algo
    eia: int = _f(1, default=0)                   # selected integrity algo


@_nas_message(0x5E)
@dataclass
class SecurityModeComplete:
    imeisv: int = _f(8, default=0)


@_nas_message(0x42)
@dataclass
class AttachAccept:
    """§8.2.1 + piggybacked ESM ActivateDefaultBearerRequest bytes."""
    guti: int = field(metadata={"width": 8})
    tac: int = _f(2, default=1)
    t3412: int = _f(1, default=6)
    esm_container: bytes = _fb(None)


@_nas_message(0x43)
@dataclass
class AttachComplete:
    esm_container: bytes = _fb(None)


@_nas_message(0x45)
@dataclass
class DetachRequest:
    """24.301 §8.2.11 (UE-originated) / §8.2.12 (network-originated):
    detach type (1 = EPS detach, 2 = switch-off — no DetachAccept
    expected) + GUTI (UE-originated) — reference NAS/MME/EMM/Detach.c."""
    guti: int = field(metadata={"width": 8})
    detach_type: int = _f(1, default=1)
    network_originated: int = _f(1, default=0)


@_nas_message(0x46)
@dataclass
class DetachAccept:
    pass


@_nas_message(0x48)
@dataclass
class TrackingAreaUpdateRequest:
    """§8.2.29: old GUTI + last visited TAC; periodic or TA-change
    triggered (reference emm/TrackingAreaUpdate.c)."""
    guti: int = field(metadata={"width": 8})
    tac: int = _f(2, default=1)
    update_type: int = _f(1, default=0)       # 0=TA-updating, 3=periodic


@_nas_message(0x49)
@dataclass
class TrackingAreaUpdateAccept:
    """§8.2.26: fresh GUTI (GUTI reallocation folded in, as the reference
    MME does) + TAI + T3412."""
    guti: int = field(metadata={"width": 8})
    tac: int = _f(2, default=1)
    t3412: int = _f(1, default=6)


@_nas_message(0x4A)
@dataclass
class TrackingAreaUpdateComplete:
    pass


@_nas_message(0x4D)
@dataclass
class ServiceRequest:
    """§8.2.25: idle->connected transition trigger. The spec's short
    format carries KSI+sequence number+short MAC; here the S-TMSI rides
    the S1AP InitialUEMessage (as the real S-TMSI IE does) and integrity
    comes from the EIA-lite secured wrapper."""
    guti: int = field(metadata={"width": 8})


@_nas_message(0x55)
@dataclass
class IdentityRequest:
    """§8.2.18: identity type 1 = IMSI (reference emm/Identification.c)."""
    id_type: int = _f(1, default=1)


@_nas_message(0x56)
@dataclass
class IdentityResponse:
    imsi: int = field(metadata={"width": 8})


@_nas_message(0x50)
@dataclass
class GutiReallocationCommand:
    guti: int = field(metadata={"width": 8})


@_nas_message(0x51)
@dataclass
class GutiReallocationComplete:
    pass


@_nas_message(0x61)
@dataclass
class EmmInformation:
    """§8.2.13: network name / local time. The wide (LV-E) text field
    also exercises >255-byte NAS payloads end-to-end (RLC-AM
    segmentation across MAC grants)."""
    network_name: bytes = _fbw()
    local_time: int = _f(4, default=0)


# ------------------------------------------------------------------ ESM --

@_nas_message(0xC1)
@dataclass
class ActivateDefaultBearerRequest:
    """24.301 §8.3.6: EPS bearer identity + QoS + APN + PDN address."""
    ebi: int = _f(1)
    qci: int = _f(1, default=9)
    pdn_ipv4: int = _f(4, default=0)
    apn: bytes = _fb(None, b"oai.ipv4")


@_nas_message(0xC2)
@dataclass
class ActivateDefaultBearerAccept:
    ebi: int = _f(1)


def pack_tft(dl_udp_dport: int, precedence: int = 0) -> bytes:
    """Traffic Flow Template, 24.008 §10.5.6.12 shape reduced to the one
    filter kind the SGi-lite user plane can match: downlink UDP
    destination port. Layout: op(1)=create | nfilters(1) | per filter:
    id(1), direction(1)=DL, precedence(1), dport(2)."""
    return bytes([0x20, 1, 0, 1, precedence & 0xFF,
                  (dl_udp_dport >> 8) & 0xFF, dl_udp_dport & 0xFF])


def unpack_tft(tft: bytes) -> int:
    """-> downlink UDP destination port of filter 0 (0 = match-all)."""
    if len(tft) < 7 or tft[1] < 1:
        return 0
    return (tft[5] << 8) | tft[6]


@_nas_message(0xC5)
@dataclass
class ActivateDedicatedBearerRequest:
    """24.301 §8.3.3 ActivateDedicatedEPSBearerContextRequest: new EBI
    linked to the default bearer's EBI, QoS (QCI) and the TFT that
    steers traffic onto it (reference openair-cn/NAS .../ESM/
    DedicatedEpsBearerContextActivation.c)."""
    ebi: int = _f(1)
    linked_ebi: int = _f(1, default=5)
    qci: int = _f(1, default=1)
    tft: bytes = _fb(None)


@_nas_message(0xC6)
@dataclass
class ActivateDedicatedBearerAccept:
    ebi: int = _f(1)


@_nas_message(0xCD)
@dataclass
class DeactivateBearerRequest:
    """24.301 §8.3.12 DeactivateEPSBearerContextRequest."""
    ebi: int = _f(1)


@_nas_message(0xCE)
@dataclass
class DeactivateBearerAccept:
    ebi: int = _f(1)


# ------------------------------------------------------------- security --

def auth_vector(k: bytes, rand: bytes):
    """Deterministic (RAND, AUTN, XRES, KASME) derivation — the protocol
    shape of Milenage f1..f5 (openair-cn/SECU) with SHA-256 in place of
    the AES kernel."""
    def h(label: bytes) -> bytes:
        return hashlib.sha256(label + k + rand).digest()
    autn = h(b"autn")[:16]
    xres = h(b"res")[:8]
    kasme = h(b"kasme")
    return autn, xres, kasme


def nas_keystream(kasme: bytes, count: int, length: int) -> np.ndarray:
    """EEA-lite keystream for the PDCP ciphering hook (mac/pdcp.py)."""
    out = bytearray()
    blk = 0
    while len(out) < length:
        out += hashlib.sha256(kasme + count.to_bytes(4, "big")
                              + blk.to_bytes(4, "big")).digest()
        blk += 1
    return np.frombuffer(bytes(out[:length]), np.uint8)
