"""The frozen reference against the port's plain path at 25 PRB on the
CPU, and the control: the reference one precision below (TF32 matrix
products) in the program's place fails the cell's limits, while the
program passes them."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from phybench import calibrate, spec, traffic
from phybench.tests.conftest import real_limits

DEV = torch.device("cpu")


def _cell(bench_root, name):
    return spec.load_cell(name, bench_root / "BENCHMARK.json", bench_root)


@pytest.mark.parametrize("name", ["dl_tiny", "ul_tiny"])
def test_reference_equals_port_plain_path(bench_root, name):
    cell = _cell(bench_root, name)
    drv, params, mix = cell.sim, cell.config["params"], cell.traffic
    port = drv.Program(params, mix, DEV, "port")
    ref = drv.Program(params, mix, DEV, "reference")
    W_port = port.W if isinstance(port.W, torch.Tensor) else port.W[0]
    W_ref = ref.W if isinstance(ref.W, torch.Tensor) else ref.W[0]
    assert torch.equal(W_port, W_ref)
    x = traffic.draw(drv.plan(params, mix), traffic.generator(5, DEV), DEV)
    a, b = port.trial(x), ref.trial(x)
    if name == "dl_tiny":
        for ra, rb in zip(a.rounds, b.rounds):
            assert torch.equal(ra.ok, rb.ok)
            assert torch.equal(ra.dci_ok, rb.dci_ok)
            assert torch.equal(ra.bit_errs, rb.bit_errs)
            for wa, wb in zip(ra.w_soft, rb.w_soft):
                torch.testing.assert_close(wa, wb, rtol=1e-5, atol=1e-4)
    else:
        assert torch.equal(a.ok, b.ok)
        assert torch.equal(a.uci_errs, b.uci_errs)
    assert torch.equal(a.errs, b.errs) and torch.equal(a.reach, b.reach)


@pytest.mark.parametrize("name", ["dl_tiny", "ul_tiny"])
def test_control_fails_the_limits(bench_root, name):
    """The cell's own limits (those of the real cells of its simulator)."""
    cell = _cell(bench_root, name)
    cell.limits = real_limits(name)
    out = calibrate.calibrate(cell, [1, 2 ** 33 + 3], [4, 2 ** 32 + 9], DEV)
    for r in out["program"]:
        assert r["soft_gap"] <= cell.limits["soft_gap"]
        assert r["decode_mismatch"] == 0
    for r in out["control"]:
        assert r["soft_gap"] > cell.limits["soft_gap"]


def test_tf32_rounding():
    from phybench.reference.device import mm, to_tf32
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12])
    assert to_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0,
                                   1.0 + 2 ** -9, -3.0]
    a = torch.randn(4, 5, dtype=torch.complex64)
    b = torch.randn(5, 3, dtype=torch.complex64)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        assert torch.equal(mm(a, b), a @ b)
        torch.backends.cuda.matmul.allow_tf32 = True
        lo = mm(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    err = (lo - a @ b).abs().max().item()
    assert 1e-5 < err < 1e-2
    assert np.isfinite(err)
