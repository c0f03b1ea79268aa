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

The cheap always-on layer is utils/profiler.py (time_meas-style stage
stats printed at sim exit like dlsim.c:3266+); this module is the opt-in
deep view.
"""
from __future__ import annotations

import contextlib
import itertools
import os

import torch

_count = itertools.count()


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


def annotate(name: str):
    """Named span on the trace timeline (record_function), usable as a
    context manager — the VCD 'signal' equivalent."""
    return torch.profiler.record_function(name)


def trace_artifacts(outdir: str) -> list:
    """Paths of trace files produced under `outdir` (for tests/tooling)."""
    found = []
    for root, _, files in os.walk(outdir):
        for f in files:
            if "trace" in f or f.endswith((".pb", ".json.gz", ".xplane.pb")):
                found.append(os.path.join(root, f))
    return found
