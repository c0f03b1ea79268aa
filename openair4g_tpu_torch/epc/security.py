"""NAS security: integrity protection + ciphering with the real 3GPP
algorithms (epc/crypto.py), selected by the Security Mode Command.

Reference parity: openair-cn/SECU + NAS/nas_message.c — every NAS message
after the security mode procedure travels in a security-protected header
(security header type, MAC, sequence number), with the EIA/EEA algorithm
chosen by the SMC applied over (COUNT, BEARER, DIRECTION, message):
EIA1/EEA1 = SNOW3G, EIA2/EEA2 = AES (CMAC/CTR), validated against the
33.401 Annex C vectors in tests/test_crypto_33401.py.

`eia_mac` (the hook mac/pdcp.py uses for RRC MAC-I) defaults to 128-EIA2;
the pre-round-5 HMAC stand-in survives as `eia_mac_lite`, a documented
test double.

A copy of openair4g_tpu/epc/security.py.
"""
from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

from .crypto import eea_apply, eia_compute

SECURED_TAG = 0xE7        # integrity protected (the SMC itself)
CIPHERED_TAG = 0xE8       # integrity protected + ciphered (post-SMC)

DIR_UPLINK = 0
DIR_DOWNLINK = 1


def eia_mac(key: bytes, count: int, bearer: int, direction: int,
            msg: bytes, alg: int = 2) -> bytes:
    """32-bit message authentication code — 128-EIA2 (AES-CMAC) by
    default; `alg` selects EIA1 (SNOW3G) or EIA2."""
    return eia_compute(alg, key, count, bearer, direction, msg)


def eia_mac_lite(key: bytes, count: int, bearer: int, direction: int,
                 msg: bytes) -> bytes:
    """The old HMAC-SHA256 stand-in, kept as a deterministic test double
    (NOT a 3GPP algorithm)."""
    block = (count.to_bytes(4, "big") + bytes([bearer & 0x1F])
             + bytes([direction & 1]) + msg)
    return hmac.new(key, block, hashlib.sha256).digest()[:4]


def derive_k_nas_int(kasme: bytes) -> bytes:
    """KASME -> K_NASint (33.401 KDF shape, SHA-256 stand-in)."""
    return hashlib.sha256(kasme + b"nas-int").digest()[:16]


def derive_k_nas_enc(kasme: bytes) -> bytes:
    """KASME -> K_NASenc (33.401 §A.7 shape)."""
    return hashlib.sha256(kasme + b"nas-enc").digest()[:16]


def derive_k_enb(kasme: bytes) -> bytes:
    """KASME -> K_eNB (33.401 §A.3 shape): the AS root key the MME hands
    the eNB in S1AP InitialContextSetupRequest (36.413 SecurityKey IE)."""
    return hashlib.sha256(kasme + b"k-enb").digest()[:16]


def derive_k_rrc_int(k_enb: bytes) -> bytes:
    """K_eNB -> K_RRCint (33.401 §A.7 shape): integrity key for SRB PDCP
    MAC-I (the PDCP hook the reference exposes in pdcp.c ->
    openair-cn/SECU EIA1/2)."""
    return hashlib.sha256(k_enb + b"rrc-int").digest()[:16]


class IntegrityError(ValueError):
    pass


@dataclass
class NasSecurityContext:
    """Per-UE NAS security context: activated by the security mode
    procedure with the SMC-selected algorithm IDs; wraps/unwraps the
    security-protected header, ciphering post-SMC traffic when EEA>0."""
    k_nas_int: bytes = b""
    k_nas_enc: bytes = b""
    ul_count: int = 0
    dl_count: int = 0
    active: bool = False
    eia: int = 2              # selected by the SMC (33.401: EIA1/EIA2)
    eea: int = 2

    def activate(self, kasme: bytes, eia: int = 2, eea: int = 2) -> None:
        self.k_nas_int = derive_k_nas_int(kasme)
        self.k_nas_enc = derive_k_nas_enc(kasme)
        self.ul_count = self.dl_count = 0
        self.eia, self.eea = eia, eea
        self.active = True

    def protect(self, msg: bytes, direction: int,
                cipher: bool = True) -> bytes:
        """Plain NAS -> security-protected NAS (header + MAC + SN).
        `cipher=False` for the SMC itself (24.301: integrity protected
        with the new context, not ciphered)."""
        if not self.active:
            return msg
        count = self.ul_count if direction == DIR_UPLINK else self.dl_count
        cipher = cipher and self.eea != 0
        body = eea_apply(self.eea, self.k_nas_enc, count, 0, direction,
                         msg) if cipher else msg
        mac = eia_mac(self.k_nas_int, count, 0, direction, body,
                      alg=self.eia)
        if direction == DIR_UPLINK:
            self.ul_count += 1
        else:
            self.dl_count += 1
        tag = CIPHERED_TAG if cipher else SECURED_TAG
        return bytes([tag]) + count.to_bytes(3, "big") + mac + body

    @staticmethod
    def peek(data: bytes) -> bytes:
        """Inner message of a non-ciphered protected PDU without
        verification — the UE must read the SMC's algorithm IDs before
        it can check the SMC's own MAC (24.301 §5.4.3.3)."""
        assert data and data[0] == SECURED_TAG
        return data[8:]

    def unprotect(self, data: bytes, direction: int) -> bytes:
        """Security-protected NAS -> plain NAS; raises IntegrityError on a
        bad MAC (the reference discards the message, nas_message.c)."""
        if not data or data[0] not in (SECURED_TAG, CIPHERED_TAG):
            if self.active:
                raise IntegrityError("unprotected NAS after SMC")
            return data
        assert self.active, "secured NAS before security activation"
        count = int.from_bytes(data[1:4], "big")
        mac, body = data[4:8], data[8:]
        want = eia_mac(self.k_nas_int, count, 0, direction, body,
                       alg=self.eia)
        if not hmac.compare_digest(mac, want):
            raise IntegrityError("NAS MAC failure")
        # replay protection: the receive count must not run backwards
        cur = self.ul_count if direction == DIR_UPLINK else self.dl_count
        if count < cur:
            raise IntegrityError("NAS replay (stale COUNT)")
        if direction == DIR_UPLINK:
            self.ul_count = count + 1
        else:
            self.dl_count = count + 1
        if data[0] == CIPHERED_TAG:
            return eea_apply(self.eea, self.k_nas_enc, count, 0,
                             direction, body)
        return body
