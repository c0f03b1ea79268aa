"""On a card: a small cell's run, untraced and traced, is correct and
reports its metrics; the control at that size fails its limits, and the
run with the control in the program's place comes out not correct. Skips
without a card (decided inside the test)."""
from __future__ import annotations

import time

import pytest
import torch

from phybench import calibrate, run, spec
from phybench.tests.conftest import real_limits


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dl_tiny", "ul_tiny"])
def test_card_run_and_control(bench_root, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    cell = spec.load_cell(name, bench_root / "BENCHMARK.json", bench_root)
    res = run.run_cell(cell, 2 ** 31 + 3, 0.5, False, dev, time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["metrics"]["trials_per_s"]["value"] > 0
    res = run.run_cell(cell, 2 ** 31 + 4, 0.5, True, dev, time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert "turbo_decode_roofline" in res["metrics"]
    out = calibrate.calibrate(cell, [5], [6], dev)
    assert out["control"][0]["soft_gap"] > cell.limits["soft_gap"]
    cell.limits = real_limits(name)
    res = run.run_cell(cell, 2 ** 31 + 5, 0.5, False, dev,
                       time.perf_counter(), "control")
    assert not res["correct"], res["checks"]
