"""The import guard and the refusal to run without a card: nothing the
command or the reference loads has the top-level name jax, jaxlib, flax
or openair4g_tpu (compared whole: openair4g_tpu_torch is the program); the
reference loads nothing of the program; without a card, or without the
program beside it, the command exits non-zero and prints no result."""
from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from phybench.tests.conftest import PHYBENCH

REPO = PHYBENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "openair4g_tpu"}


def _python(code: str, cwd=REPO) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax(bench_root):
    code = f"""
import sys, time, torch
from pathlib import Path
from phybench import run, spec, calibrate
import phybench.reference.sim.dlsim, phybench.reference.sim.ulsim
root = Path({str(bench_root)!r})
for name, tr in (("dl_tiny", True), ("ul_tiny", False)):
    cell = spec.load_cell(name, root / "BENCHMARK.json", root)
    res = run.run_cell(cell, 3, 0.1, tr, torch.device("cpu"),
                       time.perf_counter())
    assert res["correct"], res["checks"]
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "openair4g_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    r = _python("import sys\n"
                "import phybench.reference.sim.dlsim\n"
                "import phybench.reference.sim.ulsim\n"
                "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"openair4g_tpu_torch"})
    for path in (PHYBENCH / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {
                    "openair4g_tpu_torch"}, (path, n)


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["-m", "phybench.run", "--workload", "dl20_siso_b128_24db",
            "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"]
    r = subprocess.run([sys.executable, *argv], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    # the benchmark alone, without the program beside it
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PHYBENCH, tmp_path / "phybench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, *argv], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0 and r.stdout.strip() == ""
