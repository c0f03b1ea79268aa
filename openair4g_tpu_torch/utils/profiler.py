"""Per-stage timing statistics, the reference's time_meas equivalent
(counterpart of openair4g_tpu/utils/profiler.py).

Reference parity: openair1/PHY/TOOLS/time_meas.h:43-150 (time_stats_t,
start_meas/stop_meas, rdtsc cycle counters, mean+std over trials) and
print_meas / print_stats.c. The simulators print the same per-stage table
at exit (dlsim.c:3266+, ulsim.c:1605).

A stage's time is the host clock around the stage, stopped once the
stage's result is on hand: `stop_meas` and `timed` synchronize the device
of every CUDA tensor in the result (a tensor, or a tuple, list or dict of
them), so a stage includes its queued device work; CPU tensors need no
wait. Enabled globally like the reference's `opp_enabled` flag. For
kernel-level detail use utils/tracing (torch.profiler); this is the cheap
always-on layer. Everything but the wait is the reference's code.
"""
from __future__ import annotations

import math
import time
from contextlib import contextmanager

import torch

_enabled = True
_stats: dict = {}


def enable(on: bool = True):
    global _enabled
    _enabled = on


def reset_meas(name: str | None = None):
    if name is None:
        _stats.clear()
    else:
        _stats.pop(name, None)


class _Meas:
    __slots__ = ("n", "sum", "sum2", "max")

    def __init__(self):
        self.n = 0
        self.sum = 0.0
        self.sum2 = 0.0
        self.max = 0.0

    def add(self, dt: float):
        self.n += 1
        self.sum += dt
        self.sum2 += dt * dt
        self.max = max(self.max, dt)


@contextmanager
def meas(name: str, out=None):
    """Time a stage. `out` (optional) is block_until_ready'd before stopping
    the clock — pass the stage's result via a mutable list: `out.append(x)`.
    """
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _stats.setdefault(name, _Meas()).add(time.perf_counter() - t0)


def _devices(result, found: set) -> set:
    """The CUDA devices of the tensors in `result`, a tensor or a tuple,
    list or dict (nested) of them."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            found.add(result.device)
    elif isinstance(result, (tuple, list)):
        for x in result:
            _devices(x, found)
    elif isinstance(result, dict):
        for x in result.values():
            _devices(x, found)
    return found


def block_until_ready(result):
    """Wait until the device work that produces `result` is done: one
    torch.cuda.synchronize of each CUDA device its tensors lie on."""
    for dev in _devices(result, set()):
        torch.cuda.synchronize(dev)
    return result


def stop_meas(name: str, t0: float, result=None):
    """Imperative form: t0 from time.perf_counter(); blocks on result."""
    if not _enabled:
        return
    if result is not None:
        block_until_ready(result)
    _stats.setdefault(name, _Meas()).add(time.perf_counter() - t0)


def timed(name: str):
    """Decorator: times the call, blocking on the (nested) result."""
    def deco(fn):
        def wrapper(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            block_until_ready(out)
            _stats.setdefault(name, _Meas()).add(time.perf_counter() - t0)
            return out
        return wrapper
    return deco


def print_meas(file=None):
    """time_meas-style table: name, trials, mean/std/max in microseconds."""
    rows = []
    for name, m in sorted(_stats.items()):
        mean = m.sum / max(m.n, 1)
        var = max(m.sum2 / max(m.n, 1) - mean * mean, 0.0)
        rows.append((name, m.n, mean * 1e6, math.sqrt(var) * 1e6,
                     m.max * 1e6))
    w = max((len(r[0]) for r in rows), default=10)
    print(f"{'stage':<{w}}  {'trials':>7} {'mean_us':>12} {'std_us':>12} "
          f"{'max_us':>12}", file=file)
    for name, n, mean, std, mx in rows:
        print(f"{name:<{w}}  {n:>7} {mean:>12.1f} {std:>12.1f} {mx:>12.1f}",
              file=file)


def get_meas() -> dict:
    """{name: (n, mean_s, std_s, max_s)} snapshot."""
    out = {}
    for name, m in _stats.items():
        mean = m.sum / max(m.n, 1)
        var = max(m.sum2 / max(m.n, 1) - mean * mean, 0.0)
        out[name] = (m.n, mean, math.sqrt(var), m.max)
    return out
