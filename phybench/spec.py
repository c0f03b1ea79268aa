"""Discovery: a cell of BENCHMARK.json and the data files it names, found
by name under the benchmark's folder. Adding a configuration, a traffic
mix, a per-layer metric or a cell's limits adds a file; no file that is
there changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
# A traffic mix's keys: each is read, and a key outside them is refused,
# so that no setting in a mix goes unread.
TRAFFIC_KEYS = {"name", "batch", "snr_db", "warmup_steps", "trace_steps",
                "compare_steps", "why"}


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # workloads/<traffic>.json
    limits: dict          # limits/<cell>.json: {number: limit}
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries
    root: Path = HERE     # the folder of its data files

    @property
    def sim(self):
        return importlib.import_module(
            f"{__package__}.sims.{self.config['sim']}")


def _load(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SystemExit(f"phybench: {path} is missing") from None


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path, root: Path = HERE) -> Cell:
    """The cell `name` of the BENCHMARK.json at bench_path, with its data
    files under `root`."""
    bench = _load(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"phybench: no cell {name!r} in {bench_path} "
                         f"(cells: {', '.join(cells)})")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _reported(m, name)]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reported(m, name) and m["moves"] in moves]
    traffic = _load(root / "workloads" / f"{w['traffic']}.json")
    unread = set(traffic) - TRAFFIC_KEYS
    if unread:
        raise SystemExit(f"phybench: workloads/{w['traffic']}.json: "
                         f"{', '.join(sorted(unread))} not read by the "
                         "harness")
    return Cell(name=name, chips=w["chips"],
                config=_load(root / "configs" / f"{w['config']}.json"),
                traffic=traffic,
                limits=_load(root / "limits" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=per_layer, root=root)


def metric_module(name: str, root: Path = HERE):
    """The reader of per-layer metric `name`: metrics/<name>.py."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.{name.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise SystemExit(f"phybench: {path} is missing")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
