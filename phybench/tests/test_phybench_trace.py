"""The metric arithmetic on a synthetic trace: the union of busy
intervals and the idle share, span attribution, the breakdown, the
rooflines' counts from K and the iterations, and the hooks' install and
restore."""
from __future__ import annotations

import json
import types

import pytest
import torch

from phybench import spec, trace

PEAKS = json.loads((spec.HERE / "peaks.json").read_text())


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def synthetic(store=None) -> trace.Trace:
    """A 100 us window over 2 steps: kernels at 10-30 and 20-40 (overlap),
    a memcpy at 60-70; spans step 0-50 and 50-100, bitchain.decode 5-45,
    frontend 55-95; two syncs inside the steps, a launch, and the sync
    that closes the window at its end among the runtime calls; an event
    outside the window."""
    ev = [_x("user_annotation", "phybench:window", 0, 100),
          _x("user_annotation", "phybench:step", 0, 50),
          _x("user_annotation", "phybench:step", 50, 50),
          _x("user_annotation", "phybench:bitchain.decode", 5, 40),
          _x("user_annotation", "phybench:frontend", 55, 40),
          _x("user_annotation", "aten::add", 1, 2),
          _x("Kernel", "void turbo_decode_kernel<8>(float*)", 10, 20),
          _x("kernel", "void other_kernel(int)", 20, 20),
          _x("gpu_memcpy", "Memcpy DtoH", 60, 10),
          _x("kernel", "void late(int)", 150, 10),
          _x("cuda_runtime", "cudaLaunchKernel", 9, 1),
          _x("cuda_runtime", "cudaStreamSynchronize", 45, 4),
          _x("cuda_runtime", "cudaStreamSynchronize", 96, 3),
          _x("cuda_runtime", "cudaDeviceSynchronize", 100, 0),
          {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 10}]
    return trace.Trace.from_events(ev, 2, store or {"peaks": PEAKS})


def test_union_and_idle():
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    t = synthetic()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy() == [[10, 40], [60, 70]]
    assert t.busy_s() == pytest.approx(40e-6)
    assert t.device_s() == pytest.approx(50e-6)
    mod = spec.metric_module("device.idle_pct")
    assert mod.read(t) == pytest.approx(60.0)
    assert spec.metric_module("device.ms_per_step").read(t) \
        == pytest.approx(25e-6 * 1e3)


def test_counts_per_step():
    t = synthetic()
    assert spec.metric_module("host.launches_per_step").read(t) == 1.5
    assert spec.metric_module("host.syncs_per_step").read(t) == 1.0


def test_spans_and_attribution():
    t = synthetic()
    assert t.span_s("bitchain.decode") == pytest.approx(40e-6)
    assert spec.metric_module("bitchain.decode_ms").read(t) \
        == pytest.approx(20e-6 * 1e3)
    assert spec.metric_module("bitchain.encode_ms").read(t) is None
    assert t.host_label(7) == "bitchain.decode"
    assert t.host_label(50) == "step"
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["turbo_decode_kernel<8>",
                                   pytest.approx(20e-6)]
    gaps = dict(bd["idle_gaps"])
    # idle 0-10 (its middle under decode), 40-60 (under the second step
    # alone) and 70-100 (under frontend)
    assert gaps == {"bitchain.decode": pytest.approx(10e-6),
                    "step": pytest.approx(20e-6),
                    "frontend": pytest.approx(30e-6)}


def test_turbo_roofline_counts_k_and_iterations():
    mod = spec.metric_module("turbo_decode_roofline")
    K, F, iters = 5632, 0, [3, 5]
    ops = 8 * (2 * 128 * (K + 3) + 6 * K)
    assert mod.bound_s(K, F, iters, PEAKS) \
        == pytest.approx(ops / PEAKS["fp32_ops_per_s"])
    # one row at one iteration of a short block is set by its bytes
    K = 40
    n_bytes = 4 * (3 * (K + 4) + 2 * K + K) + 4 * K + 5
    assert mod.bound_s(K, 0, [1], {"fp32_ops_per_s": 1e30,
                                   "hbm_bytes_per_s": 1.0}) == n_bytes
    store = {"peaks": PEAKS,
             "turbo_iters": [[((5632, 0), torch.tensor([3, 5]))]]}
    t = synthetic(store)
    least = mod.bound_s(5632, 0, [3, 5], PEAKS)
    assert mod.read(t) == pytest.approx(100 * least / 20e-6)
    assert mod.read(synthetic()) is None


def test_viterbi_roofline_counts():
    mod = spec.metric_module("viterbi_search_roofline")
    B, W, K, n = 128, 3168, 43, 18
    assert mod.bound_s(B, W, K, n, PEAKS) == pytest.approx(
        n * B * 3 * K * 389 / PEAKS["fp32_ops_per_s"])
    assert mod.read(synthetic({"peaks": PEAKS,
                               "viterbi_search": [(B, W, K, n)]})) is None


def test_install_and_restore(monkeypatch):
    calls = []
    fake = types.ModuleType("phybench_fake_site")

    class Codec:
        def decode(self, x, iters=None):
            calls.append(iters)
            return x

    fake.Codec = Codec
    fake.helper = lambda x: x + 1
    monkeypatch.setitem(__import__("sys").modules, "phybench_fake_site", fake)
    metric = types.SimpleNamespace(
        SITES={"Sim": {"lab": ["phybench_fake_site:helper",
                               "phybench_fake_site:Codec.decode"]}},
        HOOKS={"Sim": {"phybench_fake_site:Codec.decode":
                       spec.metric_module("turbo_decode_roofline")._iters}})
    gone = types.SimpleNamespace(SITES={"Sim": {"x": [
        "phybench_fake_site:nothing"]}})
    store = {}
    orig_decode, orig_helper = Codec.decode, fake.helper
    saved, missing = trace.install({"m": metric, "gone": gone}, "Sim", store)
    assert missing == {"gone"}
    assert Codec.decode is not orig_decode and fake.helper is not orig_helper
    assert fake.helper(1) == 2
    Codec().decode(5)
    store["on"] = True
    Codec().decode(6)
    assert calls == [None, []] and store["turbo_iters"] == [[]]
    trace.restore(saved)
    assert Codec.decode is orig_decode and fake.helper is orig_helper
