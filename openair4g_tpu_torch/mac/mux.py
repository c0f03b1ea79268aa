"""MAC PDU multiplexing: 36.321 §6 subheaders, control elements, padding.

Reference parity: openair2/LAYER2/MAC/ — the eNB/UE generate_dlsch/ulsch
PDU builders (eNB_scheduler_dlsch.c fill_DLSCH_dci / generate_dlsch_header,
ue_procedures.c ue_get_sdu) pack logical-channel SDUs and MAC control
elements behind R/R/E/LCID(/F/L) subheaders into one transport block.
This module is the byte-exact equivalent: a list of (lcid, payload)
sub-PDUs <-> one MAC PDU of exactly the TB size, padding per §6.1.2
(padding subheader(s) at the end, or 1-2 leading padding subheaders when
the tail room is under 2 bytes).

LCID spaces (36.321 tables 6.2.1-1/2):
  DL-SCH: 0 CCCH, 1..10 logical channels, 28 UE Contention Resolution
          Identity CE (6 bytes), 31 padding.
  UL-SCH: 0 CCCH, 1..10 logical channels, 26 PHR CE, 29 short BSR CE,
          30 long BSR CE, 31 padding.

A copy of openair4g_tpu/mac/mux.py.
"""
from __future__ import annotations

LCID_CCCH = 0
LCID_PADDING = 31
# DL CEs
LCID_CONTENTION_RESOLUTION = 28        # 6-byte UE CR Identity
# UL CEs
LCID_PHR = 26
LCID_CQI_REPORT = 25    # in-band aperiodic CSI report (1 byte wideband
#   CQI). The 36.321 LCID space reserves 25 in this release; the real
#   carrier is UCI-on-PUSCH (ops/uci.py, bit-exact in sim/ulsim) — this
#   MAC CE is the capstone's transport for the UE-MEASURED value.
LCID_SHORT_BSR = 29
LCID_LONG_BSR = 30

# fixed control-element sizes (no F/L field; 36.321 §6.1.3)
_CE_SIZES = {LCID_CONTENTION_RESOLUTION: 6, LCID_PHR: 1,
             LCID_SHORT_BSR: 1, LCID_LONG_BSR: 3, LCID_CQI_REPORT: 1}


def _is_fixed(lcid: int) -> bool:
    return lcid in _CE_SIZES


def mac_pdu_overhead(payload_sizes: list) -> int:
    """Header bytes needed for these sub-PDU payloads (last SDU subheader
    carries no length field)."""
    total = 0
    for i, n in enumerate(payload_sizes):
        last = i == len(payload_sizes) - 1
        total += 1 if last else (2 if n < 128 else 3)
    return total


def pack_mac_pdu(subpdus: list, tb_bytes: int) -> bytes:
    """subpdus: [(lcid, payload_bytes)] -> one MAC PDU of exactly tb_bytes.

    Subheaders first (all E=1 except the final one), then payloads in the
    same order, then zero padding announced by a trailing padding
    subheader (36.321 §6.1.2)."""
    assert all(0 <= l < 32 for l, _ in subpdus)
    for lcid, pl in subpdus:
        if _is_fixed(lcid):
            assert len(pl) == _CE_SIZES[lcid], (lcid, len(pl))
    headers: list[bytes] = []
    body = b"".join(pl for _, pl in subpdus)

    def build(with_padding: bool) -> bytes:
        hs = []
        n = len(subpdus)
        for i, (lcid, pl) in enumerate(subpdus):
            last_sub = (i == n - 1) and not with_padding
            if _is_fixed(lcid) or last_sub:
                hs.append(bytes([(0 if last_sub else 0x20) | lcid]))
            elif len(pl) < 128:
                hs.append(bytes([0x20 | lcid, len(pl)]))  # F=0, 7-bit L
            else:
                assert len(pl) < (1 << 15)
                hs.append(bytes([0x20 | lcid, 0x80 | (len(pl) >> 8),
                                 len(pl) & 0xFF]))        # F=1, 15-bit L
        if with_padding:
            hs.append(bytes([LCID_PADDING]))              # E=0, padding
        return b"".join(hs)

    hdr = build(with_padding=False)
    need = len(hdr) + len(body)
    assert need <= tb_bytes, f"sub-PDUs ({need}B) exceed TB ({tb_bytes}B)"
    if need == tb_bytes:
        return hdr + body
    hdr = build(with_padding=True)
    pad = tb_bytes - len(hdr) - len(body)
    if pad < 0:       # padding subheader itself doesn't fit: single-byte
        hdr = build(with_padding=False)   # (rare; only when slack was 0)
        pad = tb_bytes - len(hdr) - len(body)
    return hdr + body + bytes(pad)


def unpack_mac_pdu(pdu: bytes) -> list:
    """MAC PDU -> [(lcid, payload_bytes)], padding stripped."""
    # pass 1: subheaders
    heads = []        # (lcid, length | None)
    pos = 0
    while True:
        b0 = pdu[pos]
        pos += 1
        e, lcid = bool(b0 & 0x20), b0 & 0x1F
        if lcid == LCID_PADDING:
            if not e:             # trailing padding: rest of PDU is pad
                heads.append((lcid, None))
                break
            continue              # leading padding byte(s)
        if _is_fixed(lcid):
            heads.append((lcid, _CE_SIZES[lcid]))
        elif not e:               # last subheader: length implicit
            heads.append((lcid, None))
        else:
            l0 = pdu[pos]
            pos += 1
            if l0 & 0x80:
                heads.append((lcid, ((l0 & 0x7F) << 8) | pdu[pos]))
                pos += 1
            else:
                heads.append((lcid, l0))
        if not e:
            break
    # pass 2: payloads
    out = []
    for i, (lcid, ln) in enumerate(heads):
        if lcid == LCID_PADDING:
            break
        if ln is None:            # implicit: runs to end of PDU
            out.append((lcid, pdu[pos:]))
            pos = len(pdu)
        else:
            out.append((lcid, pdu[pos:pos + ln]))
            pos += ln
    return out


# ------------------------------------------------------------------ CEs --

def pack_contention_resolution(msg3_prefix: bytes) -> bytes:
    """UE Contention Resolution Identity CE: first 48 bits of the Msg3
    CCCH SDU (36.321 §6.1.3.4)."""
    return (msg3_prefix + bytes(6))[:6]


def contention_resolution_matches(ce: bytes, msg3_sdu: bytes) -> bool:
    return ce == pack_contention_resolution(msg3_sdu)
