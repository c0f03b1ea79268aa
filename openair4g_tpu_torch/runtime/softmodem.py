"""softmodem-lite: real-time-paced subframe processing loop (counterpart
of openair4g_tpu/runtime/softmodem.py; a copy of it but for this
docstring).

Reference parity: targets/RT/USER/lte-softmodem.c — the eNB_thread reads
one subframe of IQ from the RF device per 1 ms period, hands it to a
per-subframe worker (eNB_thread_rx/tx), and tracks the SCHED_DEADLINE
budget. Here: IQ subframes stream through the native SPSC ring buffer
(the openair0 stand-in), the native SubframeScheduler paces 1 ms dispatch
with deadline accounting, and the worker callback feeds the PHY
receiver. ITTI-style MessageQueues carry results to a consumer task.

The worker callback runs on the scheduler's native threads. Work it
queues on a card runs on the CUDA stream asynchronously, but its result
is pickled onto the result queue, so `process` returns host values
(numbers, numpy arrays): bringing them to the host is the callback's
wait for its device work.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import FrameParms
from .native import RingBuffer, MessageQueues, SubframeScheduler

TASK_RESULT = 1          # ITTI task id of the result consumer


@dataclass
class ModemStats:
    done: int = 0
    missed: int = 0
    mean_us: float = 0.0
    max_us: float = 0.0
    underruns: int = 0


class SoftModem:
    """Streams IQ subframes from the ring through a per-subframe processor.

    `process(sf_idx, samples) -> object` runs on scheduler worker threads;
    its (pickled) results arrive on the TASK_RESULT message queue.
    """

    def __init__(self, fp: FrameParms, process, n_workers: int = 2,
                 period_us: int = 1000, ring_subframes: int = 64):
        self.fp = fp
        self.process = process
        self.bytes_per_sf = fp.samples_per_tti * 8      # complex64
        self.ring = RingBuffer(self.bytes_per_sf * ring_subframes)
        self.mq = MessageQueues()
        self.sched = SubframeScheduler(n_workers, period_us)
        self.stats = ModemStats()
        import threading
        self._rd_lock = threading.Lock()
        self._next_seq = 0
        self._blocks = {}

    # ------------------------------------------------------------- feeder --
    def feed(self, waveform: np.ndarray) -> int:
        """Producer side: push whole subframes into the ring; returns the
        number of subframes accepted."""
        w = np.ascontiguousarray(waveform.astype(np.complex64))
        n_sf = len(w) // self.fp.samples_per_tti
        fed = 0
        for s in range(n_sf):
            blk = w[s * self.fp.samples_per_tti:(s + 1)
                    * self.fp.samples_per_tti]
            if self.ring.write_array(blk) == 0:
                break
            fed += 1
        return fed

    def _block_for(self, sf: int):
        """Ordered ring consumption: workers run concurrently, but the ring
        is SPSC — all reads happen under one lock and blocks are assigned
        to subframes in feed order."""
        with self._rd_lock:
            while self._next_seq <= sf:
                raw = self.ring.read(self.bytes_per_sf)
                if raw is None:
                    break
                self._blocks[self._next_seq] = raw
                self._next_seq += 1
            return self._blocks.pop(sf, None)

    # -------------------------------------------------------------- runner --
    def run(self, n_subframes: int, realtime: bool = True) -> ModemStats:
        import pickle

        def cb(sf):
            raw = self._block_for(sf)
            if raw is None:
                self.stats.underruns += 1
                return 1
            samples = np.frombuffer(raw, np.complex64)
            out = self.process(sf, samples)
            self.mq.send(TASK_RESULT, sf, pickle.dumps(out))
            return 0

        r = self.sched.run(cb, n_subframes, realtime=realtime)
        self.stats.done = r["done"]
        self.stats.missed = r["missed"]
        self.stats.mean_us = r["mean_us"]
        self.stats.max_us = r["max_us"]
        return self.stats

    def results(self, n: int, timeout_s: float = 1.0) -> list:
        """Drain n results (sf_idx, value) from the ITTI queue."""
        import pickle
        out = []
        for _ in range(n):
            m = self.mq.recv(TASK_RESULT, timeout_s)
            if m is None:
                break
            out.append((m[0], pickle.loads(m[1])))
        return out
