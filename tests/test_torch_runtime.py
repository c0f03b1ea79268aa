"""The port's native runtime (openair4g_tpu_torch/runtime): every case of
the reference's tests/test_runtime.py retargeted at the port — ring
buffer, ITTI queues, subframe scheduler, the softmodem loop (its sync
case through the port's framegen, OFDM and phy.sync on the CPU) and the
fronthaul loopback; plus the copies: oairt.cc byte for byte, softmodem.py
and fronthaul.py by their ASTs (module docstring aside), and where the
library is built."""
import ast
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from openair4g_tpu_torch.runtime import (RingBuffer, MessageQueues,
                                         SubframeScheduler, SoftModem)
from openair4g_tpu_torch.config import FrameParms

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "openair4g_tpu" / "runtime", \
    ROOT / "openair4g_tpu_torch" / "runtime"


def test_oairt_source_is_the_reference_s():
    assert (PORT / "csrc" / "oairt.cc").read_bytes() == \
        (REF / "csrc" / "oairt.cc").read_bytes()


def _body(path: Path) -> list:
    body = ast.parse(path.read_text()).body
    assert isinstance(body[0], ast.Expr) and \
        isinstance(body[0].value.value, str)
    return [ast.dump(n) for n in body[1:]]


@pytest.mark.parametrize("name", ["softmodem.py", "fronthaul.py"])
def test_copy_equals_its_reference(name):
    assert _body(PORT / name) == _body(REF / name)


def test_library_builds_under_build_runtime():
    from openair4g_tpu_torch.runtime import native
    native.load()
    so = native.library_path()
    assert so.exists() and so.parent == ROOT / "build" / "runtime"
    assert not list((PORT / "csrc").glob("*.so"))


class TestRingBuffer:
    def test_roundtrip_and_wrap(self):
        rb = RingBuffer(64)
        assert rb.write(b"a" * 48) == 48
        assert rb.read(32) == b"a" * 32
        # wraps across the end
        assert rb.write(b"b" * 40) == 40
        assert rb.fill == 56
        assert rb.read(16) == b"a" * 16
        assert rb.read(40) == b"b" * 40
        assert rb.fill == 0

    def test_rejects_overflow_and_underflow(self):
        rb = RingBuffer(16)
        assert rb.write(b"x" * 17) == 0       # no partial writes
        assert rb.write(b"x" * 16) == 16
        assert rb.write(b"y") == 0
        assert rb.read(17) is None

    def test_numpy_array_io(self):
        rb = RingBuffer(1024)
        a = (np.arange(32) + 1j * np.arange(32)).astype(np.complex64)
        assert rb.write_array(a) == a.nbytes
        back = np.frombuffer(rb.read(a.nbytes), np.complex64)
        np.testing.assert_array_equal(back, a)

    def test_threaded_spsc(self):
        rb = RingBuffer(1 << 14)
        N = 500
        got = []

        def consumer():
            while len(got) < N:
                b = rb.read(8)
                if b is not None:
                    got.append(b)
        t = threading.Thread(target=consumer)
        t.start()
        for i in range(N):
            while rb.write(i.to_bytes(8, "little")) == 0:
                pass
        t.join(timeout=10)
        assert len(got) == N
        assert [int.from_bytes(b, "little") for b in got] == list(range(N))


class TestMessageQueues:
    def test_send_recv(self):
        mq = MessageQueues()
        mq.send(3, 42, b"hello")
        assert mq.pending(3) == 1
        mid, payload = mq.recv(3)
        assert mid == 42 and payload == b"hello"

    def test_timeout(self):
        mq = MessageQueues()
        assert mq.recv(5, timeout_s=0.05) is None

    def test_cross_thread(self):
        mq = MessageQueues()
        def sender():
            for i in range(10):
                mq.send(1, i, bytes([i]))
        t = threading.Thread(target=sender)
        t.start()
        out = [mq.recv(1, 2.0) for _ in range(10)]
        t.join()
        assert [m[0] for m in out] == list(range(10))


class TestScheduler:
    def test_freerun_completes_all(self):
        s = SubframeScheduler(n_workers=2, period_us=100)
        seen = []
        lock = threading.Lock()

        def cb(sf):
            with lock:
                seen.append(sf)
            return 0
        r = s.run(cb, 50, realtime=False)
        assert r["done"] == 50 and r["cb_fail"] == 0
        assert sorted(seen) == list(range(50))

    def test_realtime_pacing_and_deadlines(self):
        s = SubframeScheduler(n_workers=2, period_us=10000)
        import time
        s.run(lambda sf: 0, 4, realtime=False)   # warm up ctypes thunks
        t0 = time.perf_counter()
        r = s.run(lambda sf: 0, 10, realtime=True)
        dt = time.perf_counter() - t0
        assert dt >= 0.09, dt               # paced at ~10 ms/subframe
        assert r["missed"] == 0, r
        assert r["mean_us"] < 10000, r

    def test_deadline_miss_detected(self):
        import time
        s = SubframeScheduler(n_workers=1, period_us=200)

        def slow(sf):
            time.sleep(0.002)               # 10x the period
            return 0
        r = s.run(slow, 10, realtime=True)
        assert r["missed"] > 0


class TestSoftModem:
    def test_stream_processing(self):
        fp = FrameParms(n_rb=6)
        energies = {}

        def process(sf, samples):
            return float(np.mean(np.abs(samples) ** 2))

        modem = SoftModem(fp, process, n_workers=2, period_us=500)
        rng = np.random.default_rng(0)
        wave = (rng.standard_normal(20 * fp.samples_per_tti)
                + 1j * rng.standard_normal(20 * fp.samples_per_tti)
                ).astype(np.complex64)
        assert modem.feed(wave) == 20
        stats = modem.run(20, realtime=False)
        assert stats.done == 20 and stats.underruns == 0
        res = modem.results(20)
        assert len(res) == 20
        assert {sf for sf, _ in res} == set(range(20))
        for _, e in res:
            assert abs(e - 2.0) < 0.2       # unit-variance I+Q

    def test_underrun_detected(self):
        fp = FrameParms(n_rb=6)
        modem = SoftModem(fp, lambda sf, x: None)
        modem.feed(np.zeros(2 * fp.samples_per_tti, np.complex64))
        stats = modem.run(5, realtime=False)
        assert stats.underruns == 3

    def test_sync_through_modem(self):
        """Feed a framegen waveform; the PSS must be found in subframe 0."""
        from openair4g_tpu_torch.sim.framegen import generate_frame
        from openair4g_tpu_torch.sched.enb_tx import CellConfig
        fp = FrameParms(n_rb=6)
        wave = generate_frame(CellConfig(n_rb=6, n_id_cell=0, n_prb=6,
                                         n_pdcch=3, dci_L=2), device="cpu")

        from openair4g_tpu_torch.phy.sync import pss_time_replica
        rep = np.conj(pss_time_replica(0, fp.n_fft))

        def process(sf, samples):
            c = np.abs(np.convolve(samples, rep[::-1], "valid"))
            return float(c.max())

        modem = SoftModem(fp, process)
        assert modem.feed(wave) == 10
        modem.run(10, realtime=False)
        res = dict(modem.results(10))
        # PSS present in subframes 0 and 5 only
        assert res[0] > 3 * res[1], res
        assert res[5] > 3 * res[1], res


class TestFronthaul:
    """openair0-analog timestamped IQ device (runtime/fronthaul.py):
    trx_read/trx_write semantics with sample-clock timestamps, TX-lead
    deadline accounting and the RRH-split loopback over the native ring
    (lte-softmodem.c:148-242, targets/ARCH/ETHERNET)."""

    def test_timestamped_roundtrip(self):
        import numpy as np
        from openair4g_tpu_torch.runtime.fronthaul import RrhLoopback
        dev = RrhLoopback()
        burst = (np.arange(64) + 1j).astype(np.complex64)
        assert dev.write(100, burst)            # scheduled ahead of clock
        ts, rx = dev.read(256)
        assert ts == 0
        assert np.allclose(rx[100:164], burst)
        assert np.abs(rx[:100]).max() == 0      # idle carrier before it

    def test_late_tx_dropped_and_counted(self):
        import numpy as np
        from openair4g_tpu_torch.runtime.fronthaul import RrhLoopback
        dev = RrhLoopback()
        dev.read(1000)                          # clock = 1000
        assert not dev.write(500, np.ones(16, np.complex64))   # in the past
        assert dev.stats.tx_late == 1
        assert dev.write(1500, np.ones(16, np.complex64))
        assert dev.stats.tx_lead_min == -500    # tightest (late) margin kept

    def test_block_straddles_read_boundary(self):
        import numpy as np
        from openair4g_tpu_torch.runtime.fronthaul import RrhLoopback
        dev = RrhLoopback()
        burst = np.full(100, 2 + 0j, np.complex64)
        dev.write(50, burst)
        _, a = dev.read(100)                    # samples 0..99: head
        _, b = dev.read(100)                    # samples 100..199: tail
        assert np.allclose(a[50:], 2.0) and np.allclose(b[:50], 2.0)
        assert np.abs(b[50:]).max() == 0

    def test_subframe_tx_rx_through_device_with_channel(self):
        """A PHY subframe crosses the device: eNB writes the waveform at
        its TX timestamp, the 'air' hook adds AWGN, the BBU reads it back
        at the sample clock and demodulates — the openair0 path of the
        softmodem without RF silicon."""
        import numpy as np
        from openair4g_tpu_torch.runtime.fronthaul import RrhLoopback
        from openair4g_tpu_torch.config import FrameParms
        from openair4g_tpu_torch.phy import ofdm
        from openair4g_tpu_torch.phy.resource_grid import (make_grid_map,
                                                           fill_grid,
                                                           extract_data_res)
        fp = FrameParms(n_rb=6)
        gm = make_grid_map(6, 1)
        rng = np.random.default_rng(1)
        qpsk = ((1 - 2 * rng.integers(0, 2, gm.n_data_re))
                + 1j * (1 - 2 * rng.integers(0, 2, gm.n_data_re))
                ).astype(np.complex64) / np.sqrt(2)
        grid = fill_grid(torch.as_tensor(qpsk[None]), gm)
        wave = ofdm.ofdm_modulate(grid, fp).numpy()[0]
        n0 = 1e-4
        dev = RrhLoopback(channel_hook=lambda s: s + (
            (np.random.default_rng(2).standard_normal(len(s))
             + 1j * np.random.default_rng(3).standard_normal(len(s)))
            * np.sqrt(n0 / 2)).astype(np.complex64))
        sf = fp.samples_per_tti
        assert dev.write(sf, wave)              # one-subframe TX lead
        dev.read(sf)                            # idle subframe 0
        ts, rx = dev.read(sf)
        assert ts == sf
        rgrid = ofdm.ofdm_demodulate(torch.as_tensor(rx[None]), fp)
        y = extract_data_res(rgrid, gm).numpy()[0]
        # hard decisions recover the QPSK symbols
        assert np.mean(np.sign(y.real) == np.sign(qpsk.real)) == 1.0
        assert np.mean(np.sign(y.imag) == np.sign(qpsk.imag)) == 1.0
