"""The decision-directed estimate's metrics (frontend.dd_device_ms,
frontend.dd_launches_per_step) read through the program's spans
(phybench/spans.py) on a synthetic trace with correlation ids: each reads
the value worked out by hand; a trace without oai4g:estimate.dd (a
program that opens no such span, or a cell of another receiver) leaves
each out with its line on stderr; every other per-layer metric reads
the same with the dd spans as without them."""
from __future__ import annotations

import json

import pytest
import torch

from phybench import spans, spec, trace
from phybench.tests.conftest import PHYBENCH
from phybench.tests.test_phybench_spans import PEAKS, _x

NEW = ("frontend.dd_device_ms", "frontend.dd_launches_per_step")


def events(dd: bool) -> list:
    """A 100 us window over 2 steps. Spans: frontend 10-60 with
    frontend.estimate 20-50; with `dd`, estimate.dd 22-48 inside it and
    dd.joint 22-30, dd.decide 30-40, dd.refine 40-48 inside that, and
    again estimate.dd 70-80 (dd.refine 72-78) in a second frontend 65-85.
    Launches: a kernel of 10 us at 25 (dd.joint), one of 4 at 35
    (dd.decide), a fill of 2 at 45 and a cuLaunchKernel of 6 at 46
    (dd.refine), a kernel of 8 at 55 (frontend, outside the estimate), a
    copy of 3 at 75 (dd.refine) and a kernel at 79 that runs after the
    window."""
    ev = [_x("user_annotation", "phybench:window", 0, 100),
          _x("user_annotation", "phybench:step", 0, 50),
          _x("user_annotation", "phybench:step", 50, 50),
          _x("cuda_runtime", "cudaLaunchKernel", 25, 1, 1),
          _x("kernel", "void joint(float*)", 30, 10, 1),
          _x("cuda_runtime", "cudaLaunchKernel", 35, 1, 2),
          _x("kernel", "void slice(float*)", 40, 4, 2),
          _x("cuda_runtime", "cudaMemsetAsync", 45, 1, 3),
          _x("gpu_memset", "Memset (Device)", 46, 2, 3),
          _x("cuda_driver", "cuLaunchKernel", 46, 1, 4),
          _x("kernel", "void gemm(float2*)", 50, 6, 4),
          _x("cuda_runtime", "cudaLaunchKernel", 55, 1, 5),
          _x("kernel", "void mrc_llr_kernel(float*)", 60, 8, 5),
          _x("cuda_runtime", "cudaMemcpyAsync", 75, 1, 6),
          _x("gpu_memcpy", "Memcpy DtoD", 80, 3, 6),
          _x("cuda_runtime", "cudaLaunchKernel", 79, 1, 7),
          _x("kernel", "void late(int)", 150, 10, 7)]
    labels = [("frontend", 10, 60), ("frontend.estimate", 20, 50),
              ("frontend", 65, 85), ("frontend.estimate", 68, 82)]
    if dd:
        labels += [("estimate.dd", 22, 48), ("dd.joint", 22, 30),
                   ("dd.decide", 30, 40), ("dd.refine", 40, 48),
                   ("estimate.dd", 70, 80), ("dd.refine", 72, 78)]
    return ev + [_x("user_annotation", "oai4g:" + lab, a, b - a)
                 for lab, a, b in labels]


def _store() -> dict:
    return {"peaks": PEAKS,
            "turbo_iters": [[((5632, 0), torch.tensor([3, 5]))]],
            "viterbi_search": [(128, 3168, 43, 20)]}


def _traced(dd: bool):
    """The Trace of events(dd) read through the spans' hook, as a traced
    run installs it."""
    metrics = {n: spec.metric_module(n) for n in NEW}
    store = _store()
    saved, missing = trace.install(metrics, "DlsimFading", store)
    try:
        assert not missing
        return trace.Trace.from_events(events(dd), 2, store)
    finally:
        trace.restore(saved)


def test_each_metric_by_hand():
    t = _traced(True)
    read = {n: spec.metric_module(n).read(t) for n in NEW}
    # launched inside estimate.dd: 10 + 4 + 2 + 6 us in the first, 3 in
    # the second (the kernel launched at 79 runs after the window); the
    # kernel launched at 55 is the front end's, outside the estimate
    assert read["frontend.dd_device_ms"] == pytest.approx(25e-3 / 2)
    assert read["frontend.dd_launches_per_step"] == pytest.approx(5 / 2)
    s = t.store[spans.KEY]
    table = s.table()
    assert table["dd.joint"][1:3] == pytest.approx([5e-3, 0.5])
    assert table["dd.refine"][1:3] == pytest.approx([5.5e-3, 1.5])
    assert table["estimate.dd"][0] == pytest.approx((26 + 10) / 2 * 1e-3)
    # the front end's device time holds the estimate's and the kernel
    # launched at 55
    assert s.device_ms("frontend") == pytest.approx((25 + 8) / 2 * 1e-3)


@pytest.mark.parametrize("name", NEW)
def test_no_dd_span_leaves_the_metric_out(name, capsys):
    t = _traced(False)
    assert spec.metric_module(name).read(t) is None
    err = capsys.readouterr().err
    assert (f"phybench: {name}: no oai4g:estimate.dd span in the trace; "
            "the metric is left out") in err


@pytest.mark.parametrize("name", NEW)
def test_no_device_events_leave_the_metric_out(name):
    ev = [e for e in events(True)
          if e["cat"].lower() not in trace.DEVICE_CATS]
    metrics = {name: spec.metric_module(name)}
    store: dict = {}
    saved, _ = trace.install(metrics, "DlsimFading", store)
    try:
        t = trace.Trace.from_events(ev, 2, store)
    finally:
        trace.restore(saved)
    assert metrics[name].read(t) is None


def test_the_dd_spans_move_no_other_metric():
    """The dd spans lie inside frontend.estimate, so every other per-layer
    metric of BENCHMARK.json reads what it reads without them."""
    bench = json.loads((PHYBENCH.parent / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"] if m["name"] not in NEW]
    with_dd, without = _traced(True), _traced(False)
    assert with_dd.breakdown() == without.breakdown()
    for name in names:
        mod = spec.metric_module(name)
        assert mod.read(with_dd) == mod.read(without), name
    assert spec.metric_module("frontend.device_ms").read(with_dd) \
        == pytest.approx((25 + 8) / 2 * 1e-3)
