"""SCTP-lite: reliable in-order delivery for S1AP over a lossy wire.

Reference parity: the reference's S1AP rides the kernel's SCTP
(openair-cn/SCTP/sctp_primitives_server.c); its reliability properties —
sequencing, retransmission, dedup, in-order delivery — are what the S1AP
handlers assume. This module provides those properties over an
explicitly lossy in-process "wire" so the EPC slice can be tested under
drop/duplicate/reorder (the round-2 verdict's missing lossy-transport
coverage): a TSN per DATA chunk, cumulative SACK, timer-driven
retransmission, receiver-side reorder buffer.

Time is an explicit tick() like mac/rlc.py — deterministic tests.

A copy of openair4g_tpu/epc/sctp_lite.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class _Chunk:
    tsn: int
    payload: bytes


class LossyWire:
    """Unreliable unidirectional pipe: drops, duplicates and reorders
    according to a seeded RNG. `deliver()` drains what arrives now."""

    def __init__(self, rng, p_drop=0.0, p_dup=0.0, p_reorder=0.0):
        self.rng = rng
        self.p_drop = p_drop
        self.p_dup = p_dup
        self.p_reorder = p_reorder
        self._in_flight: list = []

    def send(self, pkt: bytes) -> None:
        if self.rng.random() < self.p_drop:
            return
        n = 2 if self.rng.random() < self.p_dup else 1
        for _ in range(n):
            if self._in_flight and self.rng.random() < self.p_reorder:
                self._in_flight.insert(
                    int(self.rng.integers(0, len(self._in_flight))), pkt)
            else:
                self._in_flight.append(pkt)

    def deliver(self) -> list:
        out, self._in_flight = self._in_flight, []
        return out


class SctpEndpoint:
    """One association end: send_s1ap() queues DATA chunks; tick() pumps
    the wire, retransmits unacked chunks, SACKs the peer; received PDUs
    come out of `delivered` strictly in order, exactly once."""

    RETX_TICKS = 3

    def __init__(self, tx_wire: LossyWire, rx_wire: LossyWire):
        self.tx_wire = tx_wire
        self.rx_wire = rx_wire
        self.next_tsn = 0
        self.unacked: dict[int, _Chunk] = {}
        self.retx_timer: dict[int, int] = {}
        self.cum_ack = -1                 # highest in-order TSN received
        self.rx_buf: dict[int, bytes] = {}
        self.delivered: list[bytes] = []
        self.n_retx = 0

    # ------------------------------------------------------------- send --
    def send_s1ap(self, pdu: bytes) -> None:
        ch = _Chunk(tsn=self.next_tsn, payload=pdu)
        self.next_tsn += 1
        self.unacked[ch.tsn] = ch
        self.retx_timer[ch.tsn] = self.RETX_TICKS
        self.tx_wire.send(self._pack_data(ch))

    @staticmethod
    def _pack_data(ch: _Chunk) -> bytes:
        return b"D" + ch.tsn.to_bytes(4, "big") + ch.payload

    # ------------------------------------------------------------- pump --
    def tick(self) -> None:
        """One timer tick: process arrivals, send SACK, retransmit."""
        for pkt in self.rx_wire.deliver():
            kind = pkt[:1]
            if kind == b"D":
                tsn = int.from_bytes(pkt[1:5], "big")
                if tsn > self.cum_ack and tsn not in self.rx_buf:
                    self.rx_buf[tsn] = pkt[5:]
                while self.cum_ack + 1 in self.rx_buf:
                    self.cum_ack += 1
                    self.delivered.append(self.rx_buf.pop(self.cum_ack))
            elif kind == b"S":
                ack = int.from_bytes(pkt[1:5], "big", signed=True)
                for tsn in [t for t in self.unacked if t <= ack]:
                    self.unacked.pop(tsn)
                    self.retx_timer.pop(tsn, None)
        # SACK the peer (cumulative only — lite)
        self.tx_wire.send(b"S" + self.cum_ack.to_bytes(4, "big",
                                                       signed=True))
        # retransmission timers
        for tsn in list(self.retx_timer):
            self.retx_timer[tsn] -= 1
            if self.retx_timer[tsn] <= 0:
                self.retx_timer[tsn] = self.RETX_TICKS
                self.n_retx += 1
                self.tx_wire.send(self._pack_data(self.unacked[tsn]))

    def drain(self) -> list:
        out, self.delivered = self.delivered, []
        return out


def make_association(rng, **loss_kw) -> tuple:
    """-> (endpoint_a, endpoint_b) over two lossy wires."""
    ab = LossyWire(rng, **loss_kw)
    ba = LossyWire(rng, **loss_kw)
    return SctpEndpoint(ab, ba), SctpEndpoint(ba, ab)
