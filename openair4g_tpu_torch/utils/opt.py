"""OPT packet tracer: capture MAC/NAS/S1AP PDUs to a pcap file.

Reference parity: openair2/UTIL/OPT — exports MAC PDUs in a
Wireshark-readable capture. This writes the classic pcap container
byte-exactly (libpcap 2.4 global header + per-record headers) with
LINKTYPE_USER0..2 payloads carrying the raw PDU bytes plus a 4-byte
direction/kind tag, so captures open in Wireshark (as user-DLT data)
and in any pcap tooling.

A copy of openair4g_tpu/utils/opt.py.
"""
from __future__ import annotations

import struct

LINKTYPE_USER0 = 147      # MAC PDUs
PCAP_MAGIC = 0xA1B2C3D4

DIR_UL = 0
DIR_DL = 1

KIND_MAC = 0
KIND_NAS = 1
KIND_S1AP = 2
KIND_IP = 3


class PcapWriter:
    """Streaming pcap writer. Timestamps are (frame, subframe)-derived
    microseconds (1 TTI = 1 ms) so captures align with the emulation
    timeline rather than the wall clock."""

    def __init__(self, path: str, snaplen: int = 65535):
        self._f = open(path, "wb")
        self._f.write(struct.pack("<IHHiIII", PCAP_MAGIC, 2, 4, 0, 0,
                                  snaplen, LINKTYPE_USER0))
        self.n_records = 0

    def write(self, pdu: bytes, tti: int = 0, direction: int = DIR_UL,
              kind: int = KIND_MAC, rnti: int = 0) -> None:
        tag = struct.pack("<BBH", kind, direction, rnti & 0xFFFF)
        rec = tag + pdu
        ts_us = tti * 1000
        self._f.write(struct.pack("<IIII", ts_us // 1_000_000,
                                  ts_us % 1_000_000, len(rec), len(rec)))
        self._f.write(rec)
        self.n_records += 1

    def close(self) -> None:
        self._f.close()


def read_pcap(path: str) -> list:
    """-> [(tti_ms, kind, direction, rnti, pdu_bytes)] (for tests/tools)."""
    out = []
    with open(path, "rb") as f:
        hdr = f.read(24)
        magic, = struct.unpack("<I", hdr[:4])
        assert magic == PCAP_MAGIC, hex(magic)
        while True:
            rh = f.read(16)
            if len(rh) < 16:
                break
            sec, usec, incl, _ = struct.unpack("<IIII", rh)
            rec = f.read(incl)
            kind, direction, rnti = struct.unpack("<BBH", rec[:4])
            out.append((sec * 1000 + usec // 1000, kind, direction, rnti,
                        rec[4:]))
    return out
