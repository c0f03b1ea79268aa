"""Configurations, traffic mixes, per-layer metrics and limits are data
files found by name: every cell of BENCHMARK.json finds its files, and a
new cell with a new configuration, mix, metric and limits is added in new
files alone."""
from __future__ import annotations

import hashlib
import json
import time

import pytest
import torch

from phybench import run, spec
from phybench.tests.conftest import PHYBENCH, write_json


def test_every_cell_finds_its_files():
    bench = json.loads((PHYBENCH.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], PHYBENCH.parent / "BENCHMARK.json")
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.limits) == {"soft_gap", "decode_mismatch"}
        drv = cell.sim
        assert callable(drv.plan) and callable(drv.compare)
        names = {m["name"] for m in cell.end_to_end}
        assert {"trials_per_s", "setup_s"} <= names
        assert ("subframe_p95_ms" in names) == (w["name"]
                                                == "dl20_siso_b1_24db")
        for m in cell.per_layer:
            assert callable(spec.metric_module(m["name"]).read)
    for c in bench["configs"]:
        assert (PHYBENCH.parent / c["file"]).exists()


def test_draw_plan_matches_the_configuration():
    cell = spec.load_cell("dl20_siso_b128_24db",
                          PHYBENCH.parent / "BENCHMARK.json")
    plan = cell.sim.plan(cell.config["params"], cell.traffic)
    d = cell.config["derived"]
    assert plan[0] == ("tb", "bits", (128, d["tbs"]))
    assert plan[1] == ("taps/0", "normal", (128, 1, 1, d["channel_taps"], 2))
    assert plan[2] == ("noise/0", "normal",
                       (128, 1, d["samples_per_tti"], 2))
    ul = spec.load_cell("ul20_harq_b512_16db",
                        PHYBENCH.parent / "BENCHMARK.json")
    plan = ul.sim.plan(ul.config["params"], ul.traffic)
    assert plan[0] == ("tb", "bits", (512, ul.config["derived"]["tbs"]))
    assert [p[0] for p in plan[1:4]] == ["uci/cqi", "uci/ri", "uci/ack"]
    assert len(plan) == 4 + 2 * 4


def _hashes(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_cell_in_new_files_only(bench_root):
    before = _hashes(bench_root)
    cfg = json.loads((bench_root / "configs" / "dl_small.json").read_text())
    cfg["name"] = "dl_new"
    cfg["params"]["n_rb"] = 15
    write_json(bench_root / "configs" / "dl_new.json", cfg)
    write_json(bench_root / "workloads" / "tiny2.json",
               {"name": "tiny2", "batch": 2,
                "snr_db": 12.0, "warmup_steps": 1, "trace_steps": 2,
                "compare_steps": 1, "why": "two trials a step"})
    (bench_root / "metrics" / "host.steps_seen.py").write_text(
        '"""Traced steps, a test reader."""\n\n\n'
        'def read(t):\n    return float(t.steps)\n')
    write_json(bench_root / "limits" / "dl_new_cell.json",
               json.loads((bench_root / "limits" / "dl_tiny.json")
                          .read_text()))
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dl_new_cell", "config": "dl_new",
                               "traffic": "tiny2", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "host.steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "trials_per_s"})
    write_json(bench_root / "BENCHMARK.json", bench)
    cell = spec.load_cell("dl_new_cell", bench_root / "BENCHMARK.json",
                          bench_root)
    assert cell.config["params"]["n_rb"] == 15 and cell.traffic["batch"] == 2
    cell.per_layer = [m for m in cell.per_layer
                      if m["name"] in ("host.steps_seen", "frontend.ms")]
    res = run.run_cell(cell, 11, 0.1, True, torch.device("cpu"),
                       time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["metrics"]["host.steps_seen"]["value"] == 2.0
    assert res["metrics"]["frontend.ms"]["value"] > 0
    after = _hashes(bench_root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {bench_root / "BENCHMARK.json"}


def test_a_setting_the_harness_does_not_read_is_refused(bench_root):
    mix = json.loads((bench_root / "workloads" / "tiny.json").read_text())
    write_json(bench_root / "workloads" / "tiny.json",
               dict(mix, loop="open"))
    with pytest.raises(SystemExit, match="loop not read"):
        spec.load_cell("dl_tiny", bench_root / "BENCHMARK.json", bench_root)
