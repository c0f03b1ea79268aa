"""RLC: Unacknowledged and Acknowledged mode entities (36.322).

Reference parity: openair2/LAYER2/RLC/ — UM_v9.3.0 (5/10-bit SN,
segmentation/concatenation with FI/LI framing, reordering window,
t-Reordering) and AM_v9.3.0/rlc_am.c (status PDUs with ACK_SN/NACK_SN,
retransmission on NACK, polling, max-retx threshold -> RLF).

Host-side protocol code (as in the reference); PDU payloads are `bytes`.
Time is driven by explicit `tick()` calls (one per TTI) instead of
threads + timers — deterministic under simulation.

A copy of openair4g_tpu/mac/rlc.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class UmPdu:
    """One UM PDU: `chunks` are the LI-delimited SDU pieces (36.322 keeps
    them as length indicators in the header; here the framing is explicit).
    FI semantics: fi_start = first chunk begins an SDU; fi_end = last chunk
    ends an SDU."""
    sn: int
    fi_start: bool
    fi_end: bool
    chunks: tuple

    @property
    def payload(self) -> bytes:
        return b"".join(self.chunks)


class RlcUm:
    """Unacknowledged mode: segmentation + in-order delivery with a
    reordering window."""

    def __init__(self, sn_bits: int = 10, t_reordering: int = 10):
        self.mod = 1 << sn_bits
        self.window = self.mod // 2
        self.t_reordering = t_reordering
        # TX
        self.vt_us = 0
        self._txq: list[bytes] = []
        self._tx_offset = 0
        # RX
        self.vr_ur = 0                      # earliest SN still expected
        self._rx_buf: dict[int, UmPdu] = {}
        self._timer = -1
        self._sdu_acc = bytearray()
        self._acc_valid = True
        self.delivered: list[bytes] = []

    # ------------------------------------------------------------------ TX --
    def tx_enqueue(self, sdu: bytes) -> None:
        self._txq.append(sdu)

    def tx_pdu(self, size: int) -> UmPdu | None:
        """Build one PDU of <= size payload bytes (segment + concatenate)."""
        if not self._txq:
            return None
        fi_start = self._tx_offset == 0
        chunks = []
        n = 0
        fi_end = True
        while self._txq and n < size:
            sdu = self._txq[0]
            take = min(size - n, len(sdu) - self._tx_offset)
            chunks.append(sdu[self._tx_offset:self._tx_offset + take])
            n += take
            if self._tx_offset + take == len(sdu):
                self._txq.pop(0)
                self._tx_offset = 0
            else:
                self._tx_offset += take
                fi_end = False
                break
        pdu = UmPdu(sn=self.vt_us, fi_start=fi_start, fi_end=fi_end,
                    chunks=tuple(chunks))
        self.vt_us = (self.vt_us + 1) % self.mod
        return pdu

    # ------------------------------------------------------------------ RX --
    def _sn_less(self, a: int, b: int) -> bool:
        return ((b - a) % self.mod) < self.window and a != b

    def rx_pdu(self, pdu: UmPdu) -> None:
        if pdu.sn in self._rx_buf or self._sn_less(pdu.sn, self.vr_ur):
            return                          # duplicate / stale
        self._rx_buf[pdu.sn] = pdu
        if self._timer < 0 and pdu.sn != self.vr_ur:
            self._timer = self.t_reordering
        self._advance()

    def _advance(self) -> None:
        while self.vr_ur in self._rx_buf:
            pdu = self._rx_buf.pop(self.vr_ur)
            self._reassemble(pdu)
            self.vr_ur = (self.vr_ur + 1) % self.mod
            self._timer = -1 if not self._rx_buf else self.t_reordering

    def _reassemble(self, pdu: UmPdu) -> None:
        for i, chunk in enumerate(pdu.chunks):
            starts = (i > 0) or pdu.fi_start
            ends = (i < len(pdu.chunks) - 1) or pdu.fi_end
            if starts:
                self._sdu_acc = bytearray()
                self._acc_valid = True
            if not self._acc_valid:
                continue                    # head of this SDU was lost
            self._sdu_acc += chunk
            if ends:
                self.delivered.append(bytes(self._sdu_acc))
                self._sdu_acc = bytearray()

    def tick(self) -> None:
        """One TTI: expire t-Reordering -> skip the gap."""
        if self._timer < 0:
            return
        self._timer -= 1
        if self._timer >= 0:
            return
        # jump VR(UR) past the gap to the earliest buffered SN
        if self._rx_buf:
            sns = sorted(self._rx_buf,
                         key=lambda s: (s - self.vr_ur) % self.mod)
            self.vr_ur = sns[0]
            self._acc_valid = False         # an SDU head may be missing
            self._advance()


# ------------------------------------------------------------ UM wire --
# Byte codec so UM PDUs can ride MAC transport blocks over the PHY
# (the reference's UM header: FI/E/SN + LI extensions, 36.322 §6.2.1.3;
# here the same information — FI bits, SN, per-chunk length indicators —
# in a fixed-layout PER-lite framing, consistent with rrc/messages.py).

def pack_um(pdu: "UmPdu") -> bytes:
    assert len(pdu.chunks) <= 16
    out = bytearray([(0x80 if pdu.fi_start else 0)
                     | (0x40 if pdu.fi_end else 0)
                     | (len(pdu.chunks) - 1),
                     (pdu.sn >> 8) & 0xFF, pdu.sn & 0xFF])
    for c in pdu.chunks[:-1]:           # LIs for all but the last chunk
        assert len(c) < (1 << 16)
        out += bytes([len(c) >> 8, len(c) & 0xFF])
    for c in pdu.chunks:
        out += c
    return bytes(out)


def unpack_um(data: bytes) -> "UmPdu":
    n_chunks = (data[0] & 0x0F) + 1
    sn = (data[1] << 8) | data[2]
    pos = 3
    lens = []
    for _ in range(n_chunks - 1):
        lens.append((data[pos] << 8) | data[pos + 1])
        pos += 2
    chunks = []
    for ln in lens:
        chunks.append(data[pos:pos + ln])
        pos += ln
    chunks.append(data[pos:])
    return UmPdu(sn=sn, fi_start=bool(data[0] & 0x80),
                 fi_end=bool(data[0] & 0x40), chunks=tuple(chunks))


# --------------------------------------------------------------------- AM --

@dataclass
class AmPdu:
    """AMD PDU (36.322 §6.2.1.4) or AMD PDU *segment* (§6.2.1.5,
    reference AM_v9.3.0/rlc_am_segment.c + rlc_am_resegment.c).

    `chunks` are the LI-delimited SDU pieces of the FULL PDU data field
    (FI semantics as UmPdu). A segment (is_segment=True) carries the byte
    range [so, so+len(seg_data)) of the concatenated data field, plus the
    full PDU's FI/LI metadata so the receiver can reassemble without the
    other segments' headers; lsf marks the last segment."""
    sn: int
    is_retx: bool = False
    poll: bool = False
    fi_start: bool = True
    fi_end: bool = True
    chunks: tuple = ()
    # segment-only fields (is_segment):
    is_segment: bool = False
    so: int = 0
    lsf: bool = False
    seg_data: bytes = b""
    lis: tuple = ()        # segment: LI table of the full PDU (all but
    #                        the last chunk's length)

    @property
    def payload(self) -> bytes:
        return self.seg_data if self.is_segment else b"".join(self.chunks)


@dataclass
class StatusPdu:
    ack_sn: int                   # next expected SN
    nack_sns: tuple = ()


# ------------------------------------------------------------ AM wire --
# AM data PDU: D/C|RF|P|FI|LSF header + SN + LI table (+SO for segments)
# + data (36.322 §6.2.1.4-5 fields); STATUS PDU: D/C=0 + ACK_SN + NACK
# list (§6.2.1.6). Fixed-layout PER-lite framing as rrc/messages.py.

def pack_am(pdu: "AmPdu") -> bytes:
    b0 = (0x80
          | (0x40 if pdu.is_segment else 0)
          | (0x20 if pdu.poll else 0)
          | (0x10 if pdu.fi_start else 0)
          | (0x08 if pdu.fi_end else 0)
          | (0x04 if pdu.lsf else 0)
          | (0x02 if pdu.is_retx else 0))
    lis = pdu.lis if pdu.is_segment else tuple(
        len(c) for c in pdu.chunks[:-1])
    assert len(lis) < 16
    out = bytearray([b0, (pdu.sn >> 8) & 0xFF, pdu.sn & 0xFF, len(lis)])
    for ln in lis:                      # LIs for all but the last chunk
        assert ln < (1 << 16)
        out += bytes([ln >> 8, ln & 0xFF])
    if pdu.is_segment:
        out += bytes([(pdu.so >> 8) & 0xFF, pdu.so & 0xFF])
        out += pdu.seg_data
    else:
        for c in pdu.chunks:
            out += c
    return bytes(out)


def pack_am_status(st: "StatusPdu") -> bytes:
    out = bytearray([0x00, (st.ack_sn >> 8) & 0xFF, st.ack_sn & 0xFF,
                     len(st.nack_sns)])
    for sn in st.nack_sns:
        out += bytes([(sn >> 8) & 0xFF, sn & 0xFF])
    return bytes(out)


def unpack_am(data: bytes):
    """-> AmPdu (data / data segment) or StatusPdu (control),
    dispatched on D/C."""
    if not (data[0] & 0x80):
        n = data[3]
        nacks = tuple((data[4 + 2 * i] << 8) | data[5 + 2 * i]
                      for i in range(n))
        return StatusPdu(ack_sn=(data[1] << 8) | data[2], nack_sns=nacks)
    b0 = data[0]
    sn = (data[1] << 8) | data[2]
    n_lis = data[3]
    pos = 4
    lens = []
    for _ in range(n_lis):
        lens.append((data[pos] << 8) | data[pos + 1])
        pos += 2
    common = dict(sn=sn, is_retx=bool(b0 & 0x02), poll=bool(b0 & 0x20),
                  fi_start=bool(b0 & 0x10), fi_end=bool(b0 & 0x08))
    if b0 & 0x40:                       # AMD PDU segment
        so = (data[pos] << 8) | data[pos + 1]
        pos += 2
        return AmPdu(is_segment=True, so=so, lsf=bool(b0 & 0x04),
                     seg_data=data[pos:], lis=tuple(lens), **common)
    chunks = []
    for ln in lens:
        chunks.append(data[pos:pos + ln])
        pos += ln
    chunks.append(data[pos:])
    return AmPdu(chunks=tuple(chunks), **common)


class RlcAm:
    """Acknowledged mode: segmentation/concatenation of SDUs to the MAC
    grant (reference AM_v9.3.0/rlc_am_segment.c), re-segmentation of
    retransmissions to the *current* grant (rlc_am_resegment.c),
    retransmission from status reports, max-retx threshold signalling
    radio link failure (the reference hands this to RRC)."""

    def __init__(self, sn_bits: int = 10, max_retx: int = 4,
                 poll_every: int = 8, t_poll_retransmit: int = 24):
        self.mod = 1 << sn_bits
        self.max_retx = max_retx
        self.poll_every = poll_every
        self.t_poll_retransmit = t_poll_retransmit
        self.vt_s = 0                       # next new SN
        self.vt_a = 0                       # oldest unacked SN
        self._txq: list[bytes] = []         # queued SDUs
        self._tx_offset = 0                 # bytes of txq[0] already sent
        self._sent: dict[int, AmPdu] = {}
        self._retx_count: dict[int, int] = {}
        self._retx_q: list[int] = []
        self._retx_so: dict[int, int] = {}  # re-segmentation cursor
        self._pdus_since_poll = 0
        self._poll_timer = -1               # t-PollRetransmit (36.322)
        self.rlf = False
        # RX side
        self.vr_r = 0
        self._rx: dict[int, AmPdu] = {}     # complete PDUs by SN
        self._seg: dict[int, dict] = {}     # partial segment buffers
        self._sdu_acc = bytearray()         # cross-PDU SDU accumulator
        self.delivered: list[bytes] = []

    # ------------------------------------------------------------------ TX --
    def tx_enqueue(self, sdu: bytes) -> None:
        self._txq.append(sdu)

    def has_data(self) -> bool:
        return bool(self._txq or self._retx_q)

    def tx_pdu(self, sdu: bytes | None = None,
               size: int | None = None) -> AmPdu | None:
        """Build one PDU of <= `size` payload bytes (None = unlimited).
        Retransmissions first (reference rlc_am retx queue priority); a
        NACKed PDU bigger than the current grant goes out as AMD PDU
        segments (rlc_am_resegment.c). `sdu` is enqueued first (legacy
        one-call pattern)."""
        if sdu is not None:
            self._txq.append(sdu)
        if self._retx_q:
            sn = self._retx_q[0]
            full = self._sent[sn]
            data = full.payload
            self._poll_timer = self.t_poll_retransmit
            if size is None or len(data) <= size:
                self._retx_q.pop(0)
                self._retx_so.pop(sn, None)
                return AmPdu(sn=sn, is_retx=True, poll=True,
                             fi_start=full.fi_start, fi_end=full.fi_end,
                             chunks=full.chunks)
            so = self._retx_so.get(sn, 0)
            take = min(size, len(data) - so)
            lsf = so + take == len(data)
            if lsf:
                self._retx_q.pop(0)
                self._retx_so.pop(sn, None)
            else:
                self._retx_so[sn] = so + take
            return AmPdu(sn=sn, is_retx=True, poll=lsf, is_segment=True,
                         so=so, lsf=lsf, seg_data=data[so:so + take],
                         fi_start=full.fi_start, fi_end=full.fi_end,
                         lis=tuple(len(c) for c in full.chunks[:-1]))
        if not self._txq:
            return None
        # new AMD PDU: segment + concatenate queued SDUs to the grant
        fi_start = self._tx_offset == 0
        chunks = []
        n = 0
        fi_end = True
        while self._txq and (size is None or n < size):
            # Header growth guard (ADVICE r4): each concatenated SDU past
            # the first adds a 2-byte LI, but callers budget a fixed
            # 12-byte header reserve (4 fixed + up to 4 LIs). Stop
            # concatenating once the next LI would outgrow that reserve
            # (also keeps pack_am's len(lis) < 16 wire limit safe).
            if size is not None and len(chunks) >= 5:
                fi_end = True
                break
            head = self._txq[0]
            avail = len(head) - self._tx_offset
            take = avail if size is None else min(size - n, avail)
            chunks.append(head[self._tx_offset:self._tx_offset + take])
            n += take
            if self._tx_offset + take == len(head):
                self._txq.pop(0)
                self._tx_offset = 0
            else:
                self._tx_offset += take
                fi_end = False
                break
        self._pdus_since_poll += 1
        poll = self._pdus_since_poll >= self.poll_every
        if poll:
            self._pdus_since_poll = 0
        # t-PollRetransmit arms on every send: 36.322 §5.2.2 also polls
        # when the buffers empty (the "last PDU" rule) — an un-polled
        # final PDU lost on the air must still be recoverable
        self._poll_timer = self.t_poll_retransmit
        pdu = AmPdu(sn=self.vt_s, is_retx=False, poll=poll,
                    fi_start=fi_start, fi_end=fi_end, chunks=tuple(chunks))
        self._sent[self.vt_s] = pdu
        self._retx_count[self.vt_s] = 0
        self.vt_s = (self.vt_s + 1) % self.mod
        return pdu

    def _schedule_retx(self, sn: int, why: str) -> None:
        """Count + queue one retransmission (ADVICE r3: the count moves
        only when a retransmission is actually scheduled)."""
        if sn in self._retx_q:
            return
        self._retx_count[sn] += 1
        if self._retx_count[sn] > self.max_retx:
            from ..utils.log import LOG_W
            LOG_W("RLC", "AM sn=%d exceeded maxRetx=%d (%s) -> RLF",
                  sn, self.max_retx, why)
            self.rlf = True                 # reference: maxRetx -> RRC
        else:
            self._retx_q.append(sn)
            self._retx_so.pop(sn, None)     # restart from SO=0

    def on_status(self, status: StatusPdu) -> None:
        # release acked PDUs < ACK_SN (except NACKed)
        nacked = set(status.nack_sns)
        for sn in list(self._sent):
            behind = ((status.ack_sn - 1 - sn) % self.mod) < self.mod // 2
            if behind and sn not in nacked:
                self._sent.pop(sn, None)
                self._retx_count.pop(sn, None)
                self._retx_so.pop(sn, None)
                if sn in self._retx_q:
                    self._retx_q.remove(sn)
        self.vt_a = status.ack_sn
        for sn in status.nack_sns:
            if sn in self._sent:
                self._schedule_retx(sn, "NACK")
        if not self._sent:
            self._poll_timer = -1           # everything acknowledged

    def tick(self) -> None:
        """One TTI: t-PollRetransmit countdown (36.322 §5.2.2.3). On
        expiry with data still unacknowledged, the oldest outstanding
        PDU is retransmitted with a fresh poll — this is what recovers
        the link when the polled PDU or the status report itself was
        lost on the air."""
        if self._poll_timer < 0:
            return
        self._poll_timer -= 1
        if self._poll_timer > 0 or not self._sent:
            if not self._sent:
                self._poll_timer = -1
            return
        sn = min(self._sent, key=lambda s: (s - self.vt_a) % self.mod)
        self._schedule_retx(sn, "t-PollRetransmit")
        self._poll_timer = self.t_poll_retransmit

    # ------------------------------------------------------------------ RX --
    def _rx_complete(self, pdu: AmPdu) -> None:
        self._rx[pdu.sn] = pdu
        self._seg.pop(pdu.sn, None)
        while self.vr_r in self._rx:
            self._reassemble(self._rx.pop(self.vr_r))
            self.vr_r = (self.vr_r + 1) % self.mod

    def _reassemble(self, pdu: AmPdu) -> None:
        """FI/LI-aware SDU reassembly across in-order PDUs. AM delivery
        is lossless (NACK/retx fills every gap before vr_r advances), so
        a partial SDU accumulator never needs invalidation (unlike UM)."""
        for i, chunk in enumerate(pdu.chunks):
            starts = (i > 0) or pdu.fi_start
            ends = (i < len(pdu.chunks) - 1) or pdu.fi_end
            if starts:
                self._sdu_acc = bytearray()
            self._sdu_acc += chunk
            if ends:
                self.delivered.append(bytes(self._sdu_acc))
                self._sdu_acc = bytearray()

    def _rx_segment(self, pdu: AmPdu) -> None:
        buf = self._seg.setdefault(pdu.sn, {
            "ranges": {}, "end": None,
            "fi": (pdu.fi_start, pdu.fi_end), "lis": pdu.lis})
        buf["ranges"][pdu.so] = pdu.seg_data
        if pdu.lsf:
            buf["end"] = pdu.so + len(pdu.seg_data)
        if buf["end"] is None:
            return
        # complete when the ranges cover [0, end) contiguously
        data = bytearray()
        pos = 0
        while pos < buf["end"]:
            seg = buf["ranges"].get(pos)
            if seg is None:
                return
            data += seg
            pos += len(seg)
        data = bytes(data[:buf["end"]])
        chunks = []
        off = 0
        for ln in buf["lis"]:
            chunks.append(data[off:off + ln])
            off += ln
        chunks.append(data[off:])
        self._rx_complete(AmPdu(sn=pdu.sn, fi_start=buf["fi"][0],
                                fi_end=buf["fi"][1], chunks=tuple(chunks)))

    def rx_pdu(self, pdu: AmPdu) -> StatusPdu | None:
        in_window = ((pdu.sn - self.vr_r) % self.mod) < self.mod // 2
        if in_window and pdu.sn not in self._rx:
            if pdu.is_segment:
                self._rx_segment(pdu)
            else:
                self._rx_complete(pdu)
        if pdu.poll:
            missing = []
            sn = self.vr_r
            # only SNs in [vr_r, pdu.sn) can be missing; if vr_r already
            # advanced past the polling SN, nothing is outstanding
            while sn != pdu.sn and ((pdu.sn - sn) % self.mod) < self.mod // 2:
                if sn not in self._rx:
                    missing.append(sn)
                sn = (sn + 1) % self.mod
            return StatusPdu(ack_sn=self.vr_r, nack_sns=tuple(missing))
        return None
