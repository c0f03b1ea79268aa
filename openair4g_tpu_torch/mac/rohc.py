"""ROHC-lite header compression for PDCP (RFC 3095 profile structure).

Reference parity: openair2/LAYER2/PDCP_v10.1.0's ROHC hook (the reference
links an external ROHC library for UDP/IP profile 2). This implements the
protocol shape natively: per-context IR packets carrying the full static
chain (IPv4 addresses/protocol + UDP ports), then compressed UO-style
packets carrying only a 1-byte context id + 2-byte delta (IP-ID/SN) + the
UDP length implied by the payload — a 28-byte IPv4/UDP header becomes 4
bytes after the first packet. Decompression reconstructs the full header
byte-exactly, including the recomputed IPv4 checksum.

Scope: IPv4+UDP (profile 0x0002) and a pass-through profile 0x0000 for
everything else (RFC 3095 §5.10 uncompressed) — the two profiles the
reference deployment exercises.

A copy of openair4g_tpu/mac/rohc.py.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

PKT_IR = 0xFD            # IR packet marker (context init/refresh)
PKT_CO = 0xFA            # compressed packet marker
PKT_PASS = 0xF0          # profile-0 passthrough


def _ipv4_checksum(hdr: bytes) -> int:
    s = 0
    for i in range(0, len(hdr), 2):
        s += (hdr[i] << 8) | hdr[i + 1]
    while s > 0xFFFF:
        s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF


def _parse_ipv4_udp(pkt: bytes):
    """-> (static tuple, ip_id, payload) or None if not plain IPv4/UDP."""
    if len(pkt) < 28 or pkt[0] >> 4 != 4 or (pkt[0] & 0xF) != 5:
        return None
    proto = pkt[9]
    if proto != 17:
        return None
    ip_id = struct.unpack(">H", pkt[4:6])[0]
    src, dst = pkt[12:16], pkt[16:20]
    sport, dport = struct.unpack(">HH", pkt[20:24])
    payload = pkt[28:]
    return (src, dst, sport, dport), ip_id, payload


def _build_ipv4_udp(static, ip_id: int, payload: bytes) -> bytes:
    src, dst, sport, dport = static
    total = 28 + len(payload)
    ip = bytearray(20)
    ip[0] = 0x45
    struct.pack_into(">H", ip, 2, total)
    struct.pack_into(">H", ip, 4, ip_id)
    ip[8] = 64                      # TTL
    ip[9] = 17                      # UDP
    ip[12:16] = src
    ip[16:20] = dst
    struct.pack_into(">H", ip, 10, _ipv4_checksum(bytes(ip)))
    udp = struct.pack(">HHHH", sport, dport, 8 + len(payload), 0)
    return bytes(ip) + udp + payload


@dataclass
class _Context:
    static: tuple
    last_ip_id: int


class RohcCompressor:
    def __init__(self, max_contexts: int = 16):
        self.contexts: dict[tuple, int] = {}
        self.state: dict[int, _Context] = {}
        self.max_contexts = max_contexts

    def compress(self, pkt: bytes) -> bytes:
        parsed = _parse_ipv4_udp(pkt)
        if parsed is None:
            return bytes([PKT_PASS]) + pkt
        static, ip_id, payload = parsed
        cid = self.contexts.get(static)
        if cid is None:
            if len(self.contexts) >= self.max_contexts:
                return bytes([PKT_PASS]) + pkt
            cid = len(self.contexts)
            self.contexts[static] = cid
            self.state[cid] = _Context(static, ip_id)
            src, dst, sport, dport = static
            ir = struct.pack(">BBH", PKT_IR, cid, ip_id) + src + dst + \
                struct.pack(">HH", sport, dport)
            return ir + payload
        ctx = self.state[cid]
        ctx.last_ip_id = ip_id
        return struct.pack(">BBH", PKT_CO, cid, ip_id) + payload


class RohcDecompressor:
    def __init__(self):
        self.state: dict[int, _Context] = {}

    def decompress(self, data: bytes) -> bytes:
        kind = data[0]
        if kind == PKT_PASS:
            return data[1:]
        if kind == PKT_IR:
            cid, ip_id = struct.unpack(">BH", data[1:4])
            src, dst = data[4:8], data[8:12]
            sport, dport = struct.unpack(">HH", data[12:16])
            static = (src, dst, sport, dport)
            self.state[cid] = _Context(static, ip_id)
            return _build_ipv4_udp(static, ip_id, data[16:])
        assert kind == PKT_CO, hex(kind)
        cid, ip_id = struct.unpack(">BH", data[1:4])
        ctx = self.state[cid]
        ctx.last_ip_id = ip_id
        return _build_ipv4_udp(ctx.static, ip_id, data[4:])
