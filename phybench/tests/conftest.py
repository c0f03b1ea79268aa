"""Fixtures of the benchmark's CPU tests: a benchmark root in a temporary
directory, holding small copies of the configurations (25 PRB) and a tiny
traffic mix, found by name as the real ones are."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
PHYBENCH = HERE.parent
SMALL = {"dl_small": ("dl20_siso_mcs26_eva", {"n_rb": 25, "mcs": 9}),
         "ul_small": ("ul20_pusch_mcs20_eva",
                      {"n_rb": 25, "n_rb_alloc": 25, "mcs": 10})}
# The real cell of each tiny cell's simulator.
REAL = {"dl_tiny": "dl20_siso_b128_24db", "ul_tiny": "ul20_harq_b512_16db"}
TINY = {"name": "tiny", "batch": 3, "snr_db": 10.0,
        "warmup_steps": 1, "trace_steps": 2, "compare_steps": 2,
        "why": "three trials a step at 25 PRB"}


def real_limits(tiny: str) -> dict:
    """The limits of the real cell of a tiny cell's simulator."""
    path = PHYBENCH / "limits" / f"{REAL[tiny]}.json"
    return json.loads(path.read_text())["limits"]


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture
def bench_root(tmp_path) -> Path:
    """A benchmark folder with the cells dl_tiny and ul_tiny, limits as in
    the real cells (the downlink's, the tighter), and every per-layer
    metric's reader."""
    shutil.copytree(PHYBENCH / "metrics", tmp_path / "metrics")
    shutil.copy(PHYBENCH / "peaks.json", tmp_path / "peaks.json")
    bench = json.loads((PHYBENCH.parent / "BENCHMARK.json").read_text())
    for name, (src, change) in SMALL.items():
        cfg = json.loads((PHYBENCH / "configs" / f"{src}.json").read_text())
        cfg["name"] = name
        cfg["params"].update(change)
        write_json(tmp_path / "configs" / f"{name}.json", cfg)
    write_json(tmp_path / "workloads" / "tiny.json", TINY)
    cells = [{"name": "dl_tiny", "config": "dl_small", "traffic": "tiny",
              "chips": 1, "why": "x"},
             {"name": "ul_tiny", "config": "ul_small", "traffic": "tiny",
              "chips": 1, "why": "x"}]
    limits = json.loads((PHYBENCH / "limits" / "dl20_siso_b128_24db.json")
                        .read_text())
    for c in cells:
        write_json(tmp_path / "limits" / f"{c['name']}.json", limits)
    bench["workloads"] = cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    write_json(tmp_path / "BENCHMARK.json", bench)
    return tmp_path
