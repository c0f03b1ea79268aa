"""ctypes bindings for the native runtime (csrc/oairt.cc; counterpart of
openair4g_tpu/runtime/native.py).

The shared library is built on first use with g++ (-O2 -shared) into
`build/runtime/` at the repository root, named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as built (as kernels.py does for the CUDA kernels). The source is
the reference's oairt.cc, byte for byte. Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "csrc" / "oairt.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "runtime"
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library for the current source and flags is built."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"liboairt_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)


def load() -> ctypes.CDLL:
    """Load (building if needed) and type the library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        c = ctypes
        lib.rb_create.restype = c.c_void_p
        lib.rb_create.argtypes = [c.c_size_t]
        lib.rb_destroy.argtypes = [c.c_void_p]
        for f in (lib.rb_fill, lib.rb_space):
            f.restype = c.c_size_t
            f.argtypes = [c.c_void_p]
        lib.rb_write.restype = c.c_size_t
        lib.rb_write.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t]
        lib.rb_read.restype = c.c_size_t
        lib.rb_read.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t]

        lib.mq_create.restype = c.c_void_p
        lib.mq_destroy.argtypes = [c.c_void_p]
        lib.mq_send.restype = c.c_int
        lib.mq_send.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_void_p,
                                c.c_size_t]
        lib.mq_recv.restype = c.c_long
        lib.mq_recv.argtypes = [c.c_void_p, c.c_int, c.POINTER(c.c_int),
                                c.c_void_p, c.c_size_t, c.c_long]
        lib.mq_pending.restype = c.c_size_t
        lib.mq_pending.argtypes = [c.c_void_p, c.c_int]

        lib.sched_create.restype = c.c_void_p
        lib.sched_create.argtypes = [c.c_int, c.c_long]
        lib.sched_destroy.argtypes = [c.c_void_p]
        lib.sched_run.restype = c.c_long
        lib.sched_run.argtypes = [c.c_void_p, SF_CB, c.c_void_p, c.c_int,
                                  c.c_int]
        for f in (lib.sched_missed, lib.sched_cb_fail):
            f.restype = c.c_long
            f.argtypes = [c.c_void_p]
        for f in (lib.sched_mean_us, lib.sched_max_us):
            f.restype = c.c_double
            f.argtypes = [c.c_void_p]
        _lib = lib
        return lib


SF_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


class RingBuffer:
    """SPSC byte ring (the IQ sample-stream transport)."""

    def __init__(self, capacity: int):
        self._lib = load()
        self._h = self._lib.rb_create(capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None

    def write(self, data: bytes) -> int:
        return self._lib.rb_write(self._h, data, len(data))

    def write_array(self, arr) -> int:
        import numpy as np
        a = np.ascontiguousarray(arr)
        return self._lib.rb_write(
            self._h, a.ctypes.data_as(ctypes.c_void_p), a.nbytes)

    def read(self, n: int) -> bytes | None:
        buf = ctypes.create_string_buffer(n)
        got = self._lib.rb_read(self._h, buf, n)
        return buf.raw if got == n else None

    @property
    def fill(self) -> int:
        return self._lib.rb_fill(self._h)

    @property
    def space(self) -> int:
        return self._lib.rb_space(self._h)


class MessageQueues:
    """ITTI-style per-task message queues."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.mq_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mq_destroy(self._h)
            self._h = None

    def send(self, task: int, msg_id: int, payload: bytes = b"") -> None:
        rc = self._lib.mq_send(self._h, task, msg_id, payload, len(payload))
        if rc != 0:
            raise ValueError(f"bad task id {task}")

    def recv(self, task: int, timeout_s: float = 1.0,
             max_len: int = 65536):
        """-> (msg_id, payload) or None on timeout."""
        mid = ctypes.c_int(0)
        buf = ctypes.create_string_buffer(max_len)
        n = self._lib.mq_recv(self._h, task, ctypes.byref(mid), buf,
                              max_len, int(timeout_s * 1e6))
        if n < 0:
            return None
        return mid.value, buf.raw[:n]

    def pending(self, task: int) -> int:
        return self._lib.mq_pending(self._h, task)


class SubframeScheduler:
    """Deadline-paced subframe worker pool (lte-softmodem thread model)."""

    def __init__(self, n_workers: int = 2, period_us: int = 1000):
        self._lib = load()
        self._h = self._lib.sched_create(n_workers, period_us)
        self.n_workers = n_workers
        self.period_us = period_us

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sched_destroy(self._h)
            self._h = None

    def run(self, py_cb, n_subframes: int, realtime: bool = True) -> dict:
        """py_cb(sf_idx) -> int (0 = ok). Returns run statistics."""
        exc = []

        @SF_CB
        def _cb(sf, _user):
            try:
                return int(py_cb(sf) or 0)
            except Exception as e:   # noqa: BLE001 — keep C side alive
                exc.append(e)
                return 1

        done = self._lib.sched_run(self._h, _cb, None, n_subframes,
                                   1 if realtime else 0)
        if exc:
            raise exc[0]
        return dict(done=done,
                    missed=self._lib.sched_missed(self._h),
                    cb_fail=self._lib.sched_cb_fail(self._h),
                    mean_us=self._lib.sched_mean_us(self._h),
                    max_us=self._lib.sched_max_us(self._h))
