"""GTPv1-U user-plane encapsulation (29.281).

Reference parity: openair-cn/GTPV1-U/gtpv1u.c + nw-gtpv1u stack — the
8-byte GTPv1-U header (version 1, PT=1, message type 0xFF G-PDU, length,
TEID) carrying the user IP payload between eNB and SGW, plus Echo
Request/Response keep-alives. This codec is the real wire format (not
PER-lite): the header layout is byte-exact per 29.281 §5.1.

A copy of openair4g_tpu/epc/gtpu.py.
"""
from __future__ import annotations

import struct

GTPU_ECHO_REQ = 1
GTPU_ECHO_RSP = 2
GTPU_GPDU = 255

_HDR = struct.Struct(">BBHI")      # flags, msg type, length, TEID
_FLAGS_V1_PT = 0x30                # version=1, PT=GTP, no options


def gtpu_encap(teid: int, payload: bytes, msg_type: int = GTPU_GPDU) -> bytes:
    """-> GTPv1-U PDU (header byte-exact per 29.281 §5.1)."""
    return _HDR.pack(_FLAGS_V1_PT, msg_type, len(payload), teid) + payload


def gtpu_decap(pdu: bytes) -> tuple:
    """-> (msg_type, teid, payload). Validates version/PT and length."""
    flags, msg_type, length, teid = _HDR.unpack_from(pdu)
    assert flags & 0xF0 == _FLAGS_V1_PT, hex(flags)
    payload = pdu[_HDR.size:_HDR.size + length]
    assert len(payload) == length, (len(payload), length)
    return msg_type, teid, payload
