"""The program's own spans in a traced run, as a source that a per-layer
metric's file may read.

openair4g_tpu_torch marks its layers itself (utils/tracing.annotate):
record_function spans named "oai4g:<layer>.<stage>", on the profiler's
clock. The top-level ones are bitchain.encode, tx.map, frontend,
control.dci, control.uci, bitchain.decode and sim.harq; inside them lie
encode.crc_seg, encode.turbo, encode.rate_match, frontend.channel,
frontend.estimate, frontend.detect, decode.dematch, decode.turbo and
decode.crc. The trace's correlation ids (`args.correlation`) tie each
kernel, copy and fill to the CUDA runtime or driver call that launched
it, and so to the span the host was in at that call: a layer's device
time and launches are those of the operations it launched, wherever on
the device they ran.

A metric reads them through HOOKS, a hook at the trace's reader
(Trace.from_events): it keeps a Spans of the same events under
store["program_spans"] beside the Trace, which reads what it read
without the hook. A program that opens no such span leaves the metrics
that need one out, with a line on stderr; a trace with no device events
(no card) leaves the device ones out.
"""
from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass

from .spec import metric_module
from .trace import DEVICE_CATS, union

PREFIX = "oai4g:"
KEY = "program_spans"
SITE = "phybench.trace:Trace.from_events"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# Host waits on the device, as host.syncs_per_step counts them.
WAITS = metric_module("host.syncs_per_step").WAITS
NO_SPAN = "(no span)"


class Intervals:
    """A union of (start, end) intervals, and whether a time lies in it."""

    def __init__(self, intervals):
        self.ivs = union(intervals)
        self.starts = [a for a, _ in self.ivs]

    def __contains__(self, x: float) -> bool:
        i = bisect.bisect_right(self.starts, x) - 1
        return i >= 0 and x <= self.ivs[i][1]

    def length(self) -> float:
        return sum(b - a for a, b in self.ivs)


@dataclass
class Spans:
    """One traced window's program spans, device operations with the time
    of the call that launched each (None where the trace does not say),
    runtime calls and the device's idle gaps, in microseconds of the
    trace's clock."""
    steps: int
    spans: list     # (label, t0, t1), the prefix dropped
    ops: list       # (t0, t1, launch time or None)
    runtime: list   # (name, t0)
    gaps: list      # (t0, t1): the device idle, as Trace.breakdown has it

    @classmethod
    def from_events(cls, events: list, t) -> "Spans":
        """The Spans of the Chrome trace `events`, of which `t` (a
        phybench.trace.Trace) is the Trace."""
        w0, w1 = t.window
        launch, spans, runtime, ops = {}, [], [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            t0 = float(e["ts"])
            t1 = t0 + float(e.get("dur", 0.0))
            name = str(e.get("name", ""))
            corr = (e.get("args") or {}).get("correlation")
            if cat in LAUNCH_CATS:
                if corr is not None:
                    launch[corr] = t0
                if cat == "cuda_runtime" and w0 <= t1 <= w1:
                    runtime.append((name, t0))
            elif cat in DEVICE_CATS:
                if t1 > w0 and t0 < w1:
                    ops.append((t0, t1, corr))
            elif (cat == "user_annotation" and name.startswith(PREFIX)
                  and t1 > w0 and t0 < w1):
                spans.append((name[len(PREFIX):], t0, t1))
        gaps, at = [], w0
        for a, b in t.busy() + [[w1, w1]]:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        return cls(t.steps, spans,
                   [(a, b, launch.get(c)) for a, b, c in ops],
                   runtime, gaps)

    def labels(self) -> list:
        return sorted({lab for lab, _, _ in self.spans})

    def where(self, label: str | None = None) -> Intervals:
        """The host's time in spans `label`, or in any span (None)."""
        return Intervals((a, b) for lab, a, b in self.spans
                         if label is None or lab == label)

    def host_ms(self, label: str) -> float:
        """Host ms a step in spans `label` (their union)."""
        return self.where(label).length() / self.steps * 1e-3

    def launched(self, ivs: Intervals) -> list:
        """The device operations launched while the host was in `ivs`."""
        return [(a, b) for a, b, at in self.ops
                if at is not None and at in ivs]

    def device_ms(self, label: str) -> float:
        """Device ms a step of the operations launched inside `label`."""
        return sum(b - a for a, b in self.launched(self.where(label))) \
            / self.steps * 1e-3

    def launches(self, label: str) -> float:
        """Kernels, copies and fills a step launched inside `label`."""
        return len(self.launched(self.where(label))) / self.steps

    def idle_us(self, ivs: Intervals, inside: bool = True) -> float:
        """Device idle time whose gap's middle lies in `ivs` (or, with
        inside False, outside it)."""
        return sum(b - a for a, b in self.gaps
                   if ((a + b) / 2 in ivs) == inside)

    def idle_unspanned_pct(self) -> float | None:
        """The share of the device's idle time in which the host was in
        no program span (at each gap's middle), in %."""
        total = sum(b - a for a, b in self.gaps)
        if total <= 0:
            return None
        return 100.0 * self.idle_us(self.where(), inside=False) / total

    def table(self) -> dict:
        """{label: [host ms, device ms, launches, syncs, idle ms]} a step,
        for each span label and for the host outside every span."""
        out = {}
        anywhere = self.where()
        for lab in self.labels() + [NO_SPAN]:
            if lab == NO_SPAN:
                ops = [(a, b) for a, b, at in self.ops
                       if at is None or at not in anywhere]
                syncs = sum(name in WAITS and t0 not in anywhere
                            for name, t0 in self.runtime)
                host = None
                idle = self.idle_us(anywhere, inside=False)
            else:
                ivs = self.where(lab)
                ops = self.launched(ivs)
                syncs = sum(name in WAITS and t0 in ivs
                            for name, t0 in self.runtime)
                host = ivs.length() / self.steps * 1e-3
                idle = self.idle_us(ivs)
            out[lab] = [host, sum(b - a for a, b in ops) / self.steps * 1e-3,
                        len(ops) / self.steps, syncs / self.steps,
                        idle / self.steps * 1e-3]
        return out


def _keep(fn, store):
    def from_events(events, steps, st):
        t = fn(events, steps, st)
        if KEY not in store:
            store[KEY] = Spans.from_events(events, t)
        return t
    return from_events


HOOKS = {"DlsimFading": {SITE: _keep}, "Ulsim": {SITE: _keep}}


def of(t, metric: str, label: str | None = None, device: bool = False):
    """The traced run's Spans for `metric`, or None where it cannot be
    read: no program span `label` (any program span, for None), said on
    stderr; or, with device, no device operation in the trace."""
    s = t.store.get(KEY)
    if device and not t.device:
        return None
    if s is None or not any(label is None or lab == label
                            for lab, _, _ in s.spans):
        print(f"phybench: {metric}: no {PREFIX}{label or '*'} span in the "
              "trace; the metric is left out", file=sys.stderr)
        return None
    return s
