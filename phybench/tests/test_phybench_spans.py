"""The program's own spans as a source (phybench/spans.py), on a synthetic
trace with correlation ids: the Trace, every metric that reads it and the
breakdown read exactly what they read without the program's spans and
the ids; each metric of the spans reads the value worked out by hand; a
span that is missing leaves its metric out with a line on stderr."""
from __future__ import annotations

import json
import time

import pytest
import torch

from phybench import run, spans, spec, trace
from phybench.tests.conftest import PHYBENCH

PEAKS = json.loads((spec.HERE / "peaks.json").read_text())
NEW = ("host.idle_unspanned_pct", "bitchain.encode_device_ms",
       "bitchain.encode_launches_per_step", "bitchain.dematch_ms",
       "frontend.device_ms", "control.uci_ms")


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def events(program: bool) -> list:
    """A 100 us window over 2 steps: device busy 10-40 and 60-70, idle
    0-10, 40-60 and 70-100. With `program`, the same events with their
    correlation ids, a driver launch and the program's spans:
    bitchain.encode 0-10 (encode.turbo 2-8) and 52-58, frontend 12-30
    (frontend.detect 20-30) and 72-95, bitchain.decode 32-48
    (decode.dematch 32-36), control.uci 60-70; launches at 3 (a kernel of
    20 us), 15 (a kernel of 20 us), 55 (a copy of 10 us) and 75 (a kernel
    after the window)."""
    c = (lambda n: n) if program else (lambda n: None)
    ev = [_x("user_annotation", "phybench:window", 0, 100),
          _x("user_annotation", "phybench:step", 0, 50),
          _x("user_annotation", "phybench:step", 50, 50),
          _x("user_annotation", "phybench:bitchain.decode", 5, 40),
          _x("user_annotation", "phybench:frontend", 55, 40),
          _x("Kernel", "void turbo_decode_kernel<8>(float*)", 10, 20, c(1)),
          _x("kernel", "void other_kernel(int)", 20, 20, c(2)),
          _x("gpu_memcpy", "Memcpy DtoH", 60, 10, c(3)),
          _x("kernel", "void late(int)", 150, 10, c(4)),
          _x("cuda_runtime", "cudaLaunchKernel", 3, 1, c(1)),
          _x("cuda_runtime", "cudaLaunchKernel", 15, 1, c(2)),
          _x("cuda_runtime", "cudaMemcpyAsync", 55, 1, c(3)),
          _x("cuda_runtime", "cudaStreamSynchronize", 45, 4),
          _x("cuda_runtime", "cudaStreamSynchronize", 96, 3),
          _x("cuda_runtime", "cudaDeviceSynchronize", 100, 0),
          {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 10}]
    if program:
        ev += [_x("cuda_driver", "cuLaunchKernel", 75, 1, 4)]
        ev += [_x("user_annotation", "oai4g:" + lab, a, b - a)
               for lab, a, b in (
                   ("bitchain.encode", 0, 10), ("encode.turbo", 2, 8),
                   ("bitchain.encode", 52, 58), ("frontend", 12, 30),
                   ("frontend.detect", 20, 30), ("frontend", 72, 95),
                   ("bitchain.decode", 32, 48), ("decode.dematch", 32, 36),
                   ("control.uci", 60, 70))]
    return ev


def _store():
    return {"peaks": PEAKS,
            "turbo_iters": [[((5632, 0), torch.tensor([3, 5]))]],
            "viterbi_search": [(128, 3168, 43, 18)]}


def _traced(program: bool = True):
    """The Trace of events(program) read through the spans' hook, as a
    traced run installs it."""
    hooked = {"m": spec.metric_module("bitchain.dematch_ms")}
    store = _store()
    saved, missing = trace.install(hooked, "DlsimFading", store)
    try:
        assert not missing
        return trace.Trace.from_events(events(program), 2, store)
    finally:
        trace.restore(saved)


def _existing() -> list:
    bench = json.loads((PHYBENCH.parent / "BENCHMARK.json").read_text())
    return [m["name"] for m in bench["per_layer"] if m["name"] not in NEW]


def test_the_trace_reads_what_it_read_before():
    plain = trace.Trace.from_events(events(False), 2, _store())
    t = _traced()
    for f in ("steps", "window", "device", "runtime", "spans"):
        assert getattr(t, f) == getattr(plain, f), f
    assert t.busy() == plain.busy() and t.breakdown() == plain.breakdown()
    names = _existing()
    assert len(names) == 10
    for name in names:
        mod = spec.metric_module(name)
        assert mod.read(t) == mod.read(plain), name


def test_each_metric_of_the_spans_by_hand(capsys):
    t = _traced()
    read = {n: spec.metric_module(n).read(t) for n in NEW}
    # idle 0-10 (middle in encode), 40-60 (middle 50, in no span),
    # 70-100 (middle 85, in frontend): 20 of 60 us
    assert read["host.idle_unspanned_pct"] == pytest.approx(100 / 3)
    # launched in encode: the kernel at 3 (20 us) and the copy at 55
    # (10 us), over 2 steps
    assert read["bitchain.encode_device_ms"] == pytest.approx(15e-3)
    assert read["bitchain.encode_launches_per_step"] == 1.0
    assert read["bitchain.dematch_ms"] == pytest.approx(2e-3)
    # the kernel at 15; the one launched at 75 runs after the window
    assert read["frontend.device_ms"] == pytest.approx(10e-3)
    assert read["control.uci_ms"] == pytest.approx(5e-3)
    table = t.store[spans.KEY].table()
    assert table["bitchain.decode"] == pytest.approx([8e-3, 0, 0, 0.5, 0])
    assert table[spans.NO_SPAN][1:] == pytest.approx([0, 0, 1.0, 10e-3])
    assert "phybench: span bitchain.encode:" in capsys.readouterr().err


@pytest.mark.parametrize("program", [False, True])
def test_a_missing_span_leaves_its_metric_out(program, capsys):
    """Without the program's spans (a program that opens none) every
    metric of the spans is left out and says so; with them, a span the
    program did not open (decode.dematch here) likewise."""
    t = _traced(program)
    if program:
        t.store[spans.KEY].spans = [s for s in t.store[spans.KEY].spans
                                    if s[0] != "decode.dematch"]
        gone = {"bitchain.dematch_ms"}
    else:
        gone = set(NEW)
    for name in NEW:
        value = spec.metric_module(name).read(t)
        assert (value is None) == (name in gone), name
    err = capsys.readouterr().err
    for name in gone:
        assert f"phybench: {name}: no oai4g:" in err
    assert "left out" in err


def test_no_device_events_leave_the_device_metrics_out():
    ev = [e for e in events(True)
          if e["cat"].lower() not in trace.DEVICE_CATS]
    store = _store()
    saved, _ = trace.install({"m": spec.metric_module("frontend.device_ms")},
                             "Ulsim", store)
    try:
        t = trace.Trace.from_events(ev, 2, store)
    finally:
        trace.restore(saved)
    for name in ("host.idle_unspanned_pct", "bitchain.encode_device_ms",
                 "bitchain.encode_launches_per_step", "frontend.device_ms"):
        assert spec.metric_module(name).read(t) is None
    assert spec.metric_module("control.uci_ms").read(t) \
        == pytest.approx(5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dl_tiny", "ul_tiny"])
def test_card_traced_run_reads_the_program_spans(bench_root, name):
    """On a card a traced run of a small cell reports every metric of the
    spans its cell reads (control.uci_ms in the uplink alone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(name, bench_root / "BENCHMARK.json", bench_root)
    res = run.run_cell(cell, 2 ** 31 + 7, 0.5, True, torch.device("cuda", 0),
                       time.perf_counter())
    assert res["correct"], res["checks"]
    got = {n for n in NEW if n in res["metrics"]}
    assert got == set(NEW) - ({"control.uci_ms"} if name == "dl_tiny"
                              else set())
    assert 0 <= res["metrics"]["host.idle_unspanned_pct"]["value"] <= 100
    assert res["metrics"]["bitchain.encode_launches_per_step"]["value"] > 0
