"""Execution-timeline tracing — the VCD signal dumper's equivalent
(counterpart of openair4g_tpu/utils/tracing.py).

Reference parity: openair2/UTIL/LOG/vcd_signal_dumper.c:274-470 (function
enter/exit events through a lock-free FIFO to a GTKWave VCD file, enabled
with -V). Here the artifact is a torch.profiler trace exported as Chrome
trace JSON (viewable in ui.perfetto.dev or chrome://tracing): host
operator spans, the `annotate` spans, and on a card every kernel, copy
and fill with its device time. Sims take a `trace_dir` option and wrap
one representative step in `trace()`; `annotate()` marks pipeline stages
so they show as named spans.

The program marks its own layers with `annotate`: spans named
"oai4g:<layer>.<stage>" (bitchain.encode with encode.crc_seg,
encode.turbo and encode.rate_match inside; tx.map; frontend with
frontend.channel, frontend.estimate and frontend.detect; control.dci;
control.uci; bitchain.decode with decode.dematch, decode.turbo and
decode.crc; sim.harq). They are record_function events on the
profiler's own clock, so a trace ties each CUDA runtime call, and
through its correlation id each kernel, copy and fill it launched, to the
layer that made it. With no profiler session active a span is one flag
test: no event, no sync, no allocation.

The cheap always-on layer is utils/profiler.py (time_meas-style stage
stats printed at sim exit like dlsim.c:3266+); this module is the opt-in
deep view.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch

_count = itertools.count()
# What `annotate` returns while nothing is tracing: one shared context
# that does nothing on entry and exit.
_NOOP = contextlib.nullcontext()


@contextlib.contextmanager
def trace(outdir: str, device=None):
    """Record a trace of everything inside the context into
    `outdir/trace_<pid>_<n>.json`. CPU activity always; CUDA activity as
    well when `device` is a CUDA device, or (device None) when a card is
    present. If the profiler cannot start, a warning is printed and the
    body runs untraced, as in the reference."""
    on_card = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        os.makedirs(outdir, exist_ok=True)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:                      # pragma: no cover
        print(f"[tracing] profiler unavailable: {e}")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                if on_card:
                    torch.cuda.synchronize(device)
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(
                    outdir, f"trace_{os.getpid()}_{next(_count)}.json"))
            except Exception as e:              # pragma: no cover
                print(f"[tracing] stop_trace failed: {e}")


def profile_calls(fn, n: int) -> tuple:
    """Two cycles of n calls of fn under torch.profiler, CUDA activity too
    on a card: a warm-up cycle not recorded (a session can miss the device
    events of launches made while it starts), then the recorded one.
    Returns ({event key: (count, self device µs)}, host seconds a recorded
    call). Only kernels, copies and fills count device µs; host events and
    the ranges the profiler draws on the device for annotations (its own
    step, the program's spans) count 0, so the µs add up to n calls'
    device time."""
    on_card = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            if on_card:
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n
            prof.step()
    events = {}
    for e in prof.key_averages():
        on_device = (e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation)
        us = e.self_device_time_total if on_device else 0.0
        if us > 0 or e.key not in events:
            events[e.key] = (e.count, us)
    return events, wall


def annotate(name: str):
    """Named span on the trace timeline (record_function), usable as a
    context manager — the VCD 'signal' equivalent. While no torch.profiler
    session is active (tested at each call) it returns the shared no-op
    context and makes no record_function call."""
    if not torch._C._autograd._profiler_enabled():
        return _NOOP
    return torch.profiler.record_function(name)


def trace_artifacts(outdir: str) -> list:
    """Paths of trace files produced under `outdir` (for tests/tooling)."""
    found = []
    for root, _, files in os.walk(outdir):
        for f in files:
            if "trace" in f or f.endswith((".pb", ".json.gz", ".xplane.pb")):
                found.append(os.path.join(root, f))
    return found
