"""openair0-analog IQ device layer: timestamped sample-stream front haul
(counterpart of openair4g_tpu/runtime/fronthaul.py; a copy of it but for
this docstring).

Reference parity: the device-independent `openair0_device` abstraction
(targets/RT/USER/lte-softmodem.c:148-242 — trx_read_func returns a
sample-clock `openair0_timestamp` with each block; trx_write_func takes
the timestamp the samples must hit the air at, and the RT loop writes TX
subframe n at rx_ts + N*samples_per_tti so the hardware has lead time)
and the ETHERNET RRH split (targets/ARCH/ETHERNET, rrh_gw.c — raw IQ
between the radio head and the baseband unit over a transport link).

The "transport link" is the native C++ SPSC ring (runtime/csrc/oairt.cc)
carrying framed [timestamp | complex64 samples] blocks — the
shared-memory analog of the RRH ethernet stream; the sample clock is
modeled (monotonic counter advanced by reads), and TX writes are checked
against the clock for the reference's late-packet accounting
(lte-softmodem's "TX underrun/late" counters). Samples are numpy on the
host, as a NIC or DMA feed would hand them over; everything above this
layer (softmodem-lite, sched/, PHY) is transport-agnostic.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .native import RingBuffer

_HDR = struct.Struct("<qi")        # (timestamp, n_samples)


@dataclass
class FronthaulStats:
    rx_blocks: int = 0
    tx_blocks: int = 0
    tx_late: int = 0               # writes whose deadline already passed
    tx_lead_min: int | None = None  # tightest observed TX lead (samples)


class IqStream:
    """One direction of framed, timestamped IQ over the native ring."""

    def __init__(self, capacity_samples: int = 1 << 20):
        self.ring = RingBuffer(capacity_samples * 8 + (1 << 16))

    def push(self, timestamp: int, samples: np.ndarray) -> bool:
        samples = np.ascontiguousarray(samples, np.complex64)
        blob = _HDR.pack(int(timestamp), len(samples)) + samples.tobytes()
        if self.ring.space < len(blob):
            return False
        self.ring.write(blob)
        return True

    def pop(self) -> tuple[int, np.ndarray] | None:
        hdr = self.ring.read(_HDR.size)
        if hdr is None:
            return None
        ts, n = _HDR.unpack(hdr)
        raw = self.ring.read(n * 8)
        assert raw is not None, "framing torn — writer must push whole blocks"
        return ts, np.frombuffer(raw, np.complex64)


class RrhLoopback:
    """A BBU-side `openair0_device` whose radio head is a loopback (or a
    user channel hook): the RRH split without the ethernet NIC.

    * `read(n)` -> (timestamp, samples): advances the modeled sample
      clock by n, serving samples the TX side scheduled for those
      timestamps (plus `noise_floor` if nothing was scheduled — an idle
      carrier), exactly like a full-duplex radio head.
    * `write(timestamp, samples)`: schedules TX samples to hit the air
      at `timestamp`; a timestamp at-or-before the current clock counts
      as LATE (the reference's late-packet accounting) and the block is
      dropped, as real hardware would drop it.
    * `channel_hook(samples) -> samples`: optional air model applied
      between TX and the looped-back RX (AWGN, delay, ...).
    """

    def __init__(self, channel_hook=None, noise_floor: float = 0.0,
                 seed: int = 0):
        self.clock = 0                      # sample-clock "now" (RX side)
        self.tx = IqStream()
        self.stats = FronthaulStats()
        self.channel_hook = channel_hook
        self.noise_floor = noise_floor
        self._rng = np.random.default_rng(seed)
        self._sched: dict[int, np.ndarray] = {}   # ts -> pending TX block

    # ----------------------------------------------------------- TX side --
    def write(self, timestamp: int, samples: np.ndarray) -> bool:
        """trx_write_func: samples must be scheduled AHEAD of the clock."""
        lead = int(timestamp) - self.clock
        if self.stats.tx_lead_min is None or lead < self.stats.tx_lead_min:
            self.stats.tx_lead_min = lead
        if lead <= 0:
            self.stats.tx_late += 1
            return False
        ok = self.tx.push(timestamp, samples)
        if ok:
            self.stats.tx_blocks += 1
        return ok

    # ----------------------------------------------------------- RX side --
    def _sched_add(self, ts: int, s: np.ndarray) -> None:
        """Schedule samples at ts, ACCUMULATING on collision (ADVICE r4:
        two blocks landing on the same timestamp must sum 'in the air',
        not overwrite)."""
        old = self._sched.get(ts)
        if old is None:
            self._sched[ts] = s
            return
        if len(old) < len(s):
            old, s = s, old.copy()
        else:
            old = old.copy()
        old[:len(s)] += s
        self._sched[ts] = old

    def _drain_tx(self) -> None:
        while True:
            blk = self.tx.pop()
            if blk is None:
                return
            ts, s = blk
            self._sched_add(ts, s)

    def read(self, n: int) -> tuple[int, np.ndarray]:
        """trx_read_func: n samples starting at the current clock."""
        self._drain_tx()
        start = self.clock
        out = np.zeros(n, np.complex64)
        if self.noise_floor > 0:
            out += (self._rng.standard_normal(n)
                    + 1j * self._rng.standard_normal(n)).astype(np.complex64) \
                * np.sqrt(self.noise_floor / 2)
        for ts in sorted(self._sched):
            if ts >= start + n:
                break
            s = self._sched.pop(ts)
            if self.channel_hook is not None:
                s = np.asarray(self.channel_hook(s), np.complex64)
            a = max(ts, start)
            b = min(ts + len(s), start + n)
            if b > a:
                out[a - start:b - start] += s[a - ts:b - ts]
            if ts + len(s) > start + n:     # tail spills into the future
                self._sched_add(start + n, s[b - ts:].copy())
        self.clock += n
        self.stats.rx_blocks += 1
        return start, out
