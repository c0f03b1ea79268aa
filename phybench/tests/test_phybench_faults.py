"""A run with the timed path broken underneath comes out not correct: the
harness's run of a small cell on the CPU (its look for a card skipped),
with each fault a cell of this benchmark can have planted in the program
(phybench.faults), and with the control in the program's place. One chip
a cell, so no exchange between chips to leave out."""
from __future__ import annotations

import time

import pytest
import torch

from phybench import faults, run, spec
from phybench.tests.conftest import real_limits

SEED = 2 ** 31 + 77


def _run(bench_root, cell: str, impl: str = "port",
         limits: dict | None = None) -> dict:
    c = spec.load_cell(cell, bench_root / "BENCHMARK.json", bench_root)
    c.limits = limits or c.limits
    return run.run_cell(c, SEED, 0.5, False, torch.device("cpu"),
                        time.perf_counter(), impl)


@pytest.mark.parametrize("cell", ["dl_tiny", "ul_tiny"])
def test_sound_run_is_correct(bench_root, cell):
    res = _run(bench_root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", ["dl_tiny", "ul_tiny"])
def test_fault_is_not_correct(bench_root, cell, fault):
    with faults.FAULTS[fault]():
        res = _run(bench_root, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["dl_tiny", "ul_tiny"])
def test_control_run_is_not_correct(bench_root, cell):
    """Against the limits of the real cells of the tiny cell's simulator."""
    res = _run(bench_root, cell, "control", real_limits(cell))
    assert not res["correct"], res["checks"]
    assert res["checks"]["soft_gap"]["value"] \
        > res["checks"]["soft_gap"]["limit"]
    assert not torch.backends.cuda.matmul.allow_tf32


def test_faults_are_undone():
    from openair4g_tpu_torch.phy import pdsch
    from openair4g_tpu_torch.sim import dlsim, ulsim
    sites = [(pdsch.DlschCodec, "decode"), (dlsim.DlsimFading, "round"),
             (ulsim.Ulsim, "round_llrs")]
    before = [getattr(o, n) for o, n in sites]
    for plant in faults.FAULTS.values():
        with plant():
            assert [getattr(o, n) for o, n in sites] != before
    assert [getattr(o, n) for o, n in sites] == before
