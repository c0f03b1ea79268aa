"""The traced run's instruments: the benchmark's own spans and hooks at
the lookup sites that the per-layer metrics' files name, torch.profiler
over a fixed number of steps, and the reading of its Chrome trace.

A site is "module:Attr.path", the name where the program looks the
function up (a module's global, or a class's method). A span is a
torch.profiler.record_function named "phybench:<label>" around each call;
it adds no synchronisation. A hook is a metric's own wrapper factory,
`factory(fn, store) -> fn`, that may record into `store` while
store["on"] is set, which is only inside the traced window.
"""
from __future__ import annotations

import functools
import importlib
import json
import os
import sys
import tempfile
from dataclasses import dataclass, field

import torch

PREFIX = "phybench:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime",)


def resolve(site: str):
    """(owner, attribute name) of a site, or None where it is not found."""
    mod_name, _, path = site.partition(":")
    try:
        obj = importlib.import_module(mod_name)
    except ImportError:
        return None
    *owners, attr = path.split(".")
    for part in owners:
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return (obj, attr) if callable(getattr(obj, attr, None)) else None


def _span(label: str, fn):
    name = PREFIX + label

    @functools.wraps(fn)
    def spanned(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return spanned


def install(metrics: dict, sim: str, store: dict) -> tuple:
    """Wrap each site that the metrics' modules name for this simulator.
    metrics {name: module}. Returns (the originals to restore, the names
    of metrics with a site not found)."""
    wraps: dict = {}      # site -> {key: (metric names, wrapper)}
    for name, mod in metrics.items():
        for label, sites in getattr(mod, "SITES", {}).get(sim, {}).items():
            for site in sites:
                entry = wraps.setdefault(site, {}).setdefault(
                    ("span", label),
                    ([], lambda fn, label=label: _span(label, fn)))
                entry[0].append(name)
        for site, factory in getattr(mod, "HOOKS", {}).get(sim,
                                                           {}).items():
            wraps.setdefault(site, {})[("hook", name)] = (
                [name], lambda fn, f=factory: f(fn, store))
    saved, missing = [], set()
    for site, ws in wraps.items():
        found = resolve(site)
        if found is None:
            for names, _ in ws.values():
                for name in names:
                    if name not in missing:
                        print(f"phybench: {name}: site {site} not found; "
                              "the metric is left out", file=sys.stderr)
                    missing.add(name)
            continue
        owner, attr = found
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))
        for _, wrap in ws.values():
            fn = wrap(fn)
        setattr(owner, attr, fn)
    return saved, missing


def restore(saved: list) -> None:
    for owner, attr, original in reversed(saved):
        setattr(owner, attr, original)


def profile(step, n: int, store: dict, device) -> "Trace":
    """torch.profiler over n calls of `step` inside the span
    "phybench:window" (each call inside "phybench:step", the window closed
    by a device sync); the Chrome trace is written under TMPDIR, read and
    deleted."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    store["on"] = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(PREFIX + "window"):
                for _ in range(n):
                    with torch.profiler.record_function(PREFIX + "step"):
                        step()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
    finally:
        store["on"] = False
    fd, path = tempfile.mkstemp(prefix="phybench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace.from_events(events, n, store)


def union(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short(name: str, n: int = 100) -> str:
    """A kernel's name without its return type, its argument list and
    "(anonymous namespace)::", at most n characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.strip()[:n]


@dataclass
class Trace:
    """One traced window: device events, runtime calls and the
    benchmark's spans, in microseconds of the trace's clock."""
    steps: int
    window: tuple
    device: list = field(default_factory=list)    # (cat, name, t0, t1)
    runtime: list = field(default_factory=list)   # (name, t0, t1)
    spans: list = field(default_factory=list)     # (label, t0, t1)
    store: dict = field(default_factory=dict)

    @classmethod
    def from_events(cls, events: list, steps: int, store: dict) -> "Trace":
        device, runtime, spans = [], [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            t0 = float(e["ts"])
            t1 = t0 + float(e.get("dur", 0.0))
            name = str(e.get("name", ""))
            if cat in DEVICE_CATS:
                device.append((cat, name, t0, t1))
            elif cat in RUNTIME_CATS:
                runtime.append((name, t0, t1))
            elif cat == "user_annotation" and name.startswith(PREFIX):
                spans.append((name[len(PREFIX):], t0, t1))
        windows = [(a, b) for label, a, b in spans if label == "window"]
        if len(windows) != 1:
            raise RuntimeError(f"phybench: the trace holds {len(windows)} "
                               "window spans")
        w = windows[0]
        inside = [d for d in device if d[3] > w[0] and d[2] < w[1]]
        return cls(steps, w, inside,
                   [r for r in runtime if w[0] <= r[1] <= w[1]],
                   [s for s in spans if s[0] != "window"], store)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def _clip(self, a: float, b: float) -> tuple:
        return max(a, self.window[0]), min(b, self.window[1])

    def busy(self) -> list:
        """The device's busy intervals inside the window."""
        return union(self._clip(t0, t1) for _, _, t0, t1 in self.device)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def device_s(self) -> float:
        """Device time summed over every device event in the window."""
        return sum(t1 - t0 for _, _, t0, t1 in self.device) * 1e-6

    def kernel_s(self, part: str) -> float:
        """Summed device time of the kernels whose name holds `part`."""
        return sum(t1 - t0 for cat, name, t0, t1 in self.device
                   if cat == "kernel" and part in name) * 1e-6

    def span_s(self, label: str) -> float:
        """Host seconds inside spans `label` (their union)."""
        return sum(b - a for a, b in union(
            (t0, t1) for lab, t0, t1 in self.spans if lab == label)) * 1e-6

    def has_span(self, label: str) -> bool:
        return any(lab == label for lab, _, _ in self.spans)

    def host_label(self, t: float) -> str:
        """The innermost benchmark span the host was in at time t."""
        best = None
        for lab, t0, t1 in self.spans:
            if t0 <= t <= t1 and (best is None or t0 > best[1]):
                best = (lab, t0)
        return best[0] if best else "outside any step"

    def breakdown(self, n: int = 10) -> dict:
        """The device operations with the most time, and the device's idle
        time by the innermost span the host was in at each gap's middle,
        each as [name, seconds], n at most."""
        by_op: dict = {}
        for _, name, t0, t1 in self.device:
            k = short(name)
            by_op[k] = by_op.get(k, 0.0) + (t1 - t0) * 1e-6
        gaps, t = [], self.window[0]
        for a, b in self.busy() + [[self.window[1], self.window[1]]]:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        by_host: dict = {}
        for a, b in gaps:
            k = self.host_label(0.5 * (a + b))
            by_host[k] = by_host.get(k, 0.0) + (b - a) * 1e-6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [list(kv) for kv in top],
                "idle_gaps": [list(kv) for kv in idle]}
