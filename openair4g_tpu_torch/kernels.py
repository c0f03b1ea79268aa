"""Build and load the hand-written CUDA kernels (csrc/*.cu).

All sources compile in one `nvcc` call for `sm_90a` into one shared library
with a plain C interface, loaded with ctypes. The library lands in
`build/kernels/` at the repository root, named by a hash of the sources, so
an edited source is rebuilt and an unchanged one is loaded as built.
Nothing here runs at import: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("turbo_half_iter.cu", "mrc_llr.cu", "viterbi.cu",
           "dlsch_encode.cu", "dlsch_decode.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.turbo_half_iter_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.turbo_half_iter_launch.restype = i
    ll, f = ctypes.c_longlong, ctypes.c_float
    lib.mrc_llr_launch.argtypes = [p, p, p, f, p] + [ll] * 10 + [i, i, p]
    lib.mrc_llr_launch.restype = i
    lib.demap_llr_launch.argtypes = [p, p, f, p] + [ll] * 6 + [i, p]
    lib.demap_llr_launch.restype = i
    lib.turbo_half_iter_v1_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.turbo_half_iter_v1_launch.restype = i
    lib.turbo_decode_launch.argtypes = [p] * 9 + [i] * 11 + [p]
    lib.turbo_decode_launch.restype = i
    lib.turbo_decode_plan.argtypes = [i] * 3
    lib.turbo_decode_plan.restype = i
    lib.viterbi_launch.argtypes = [p, p, i, i, i, p]
    lib.viterbi_launch.restype = i
    lib.viterbi_search_launch.argtypes = [p, ll, i, p] + [i] * 5 + [p] * 3
    lib.viterbi_search_launch.restype = i
    lib.dlsch_encode_launch.argtypes = [p, i, p, p, i, p, i, i, p, p, i, i,
                                        p]
    lib.dlsch_encode_launch.restype = i
    lib.dlsch_select_launch.argtypes = [p, i, p, i, p, i, i, p]
    lib.dlsch_select_launch.restype = i
    lib.dlsch_dematch_launch.argtypes = [p, ll, ctypes.POINTER(ll), i, p, i,
                                         p, p, p, i, i, i, i, p]
    lib.dlsch_dematch_launch.restype = i
    pp = ctypes.POINTER(p)
    lib.dlsch_tb_check_launch.argtypes = [pp, pp, i, p, i, p, i, p, p, i, p]
    lib.dlsch_tb_check_launch.restype = i
    lib.empty_launch.argtypes = [p]
    lib.empty_launch.restype = i


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the CDLL."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = [_CSRC / s for s in SOURCES]
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libopenair4g_kernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        log = r.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      ptxas=log, flags=" ".join(NVCC_FLAGS))
    _lib = lib
    return lib


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on t's device: where a kernel
    that reads t launches."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
