"""The port's hand-written CUDA kernels and its device entry on a card.

Every test here needs a CUDA device and skips without one. The module
imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(tests/conftest.py sets jax up for the rest of the suite, hence
--noconftest there).
"""
import numpy as np
import pytest
import torch

from openair4g_tpu_torch.device import launch_counts
from openair4g_tpu_torch.ops.equalize_llr import mrc_llr, mrc_llr_ref
from openair4g_tpu_torch.ops.turbo_cuda import (BIG, half_iteration,
                                                half_iteration_ref)
from openair4g_tpu_torch.sim.dlsim import DlsimFading, DlsimFadingConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("B,W,n_w", [(64, 48, 3), (64, 96, 2),
                                     (1408, 240, 24)])
def test_turbo_kernel_matches_plain_version(cuda, B, W, n_w):
    rng = np.random.default_rng(W + n_w)
    lin = (3.0 * rng.standard_normal((B, W * n_w))).astype(np.float32)
    lp = (3.0 * rng.standard_normal((B, W * n_w))).astype(np.float32)
    lin[:, -7:] = BIG
    lp[:, -7:] = BIG
    lin, lp = torch.from_numpy(lin).to(cuda), torch.from_numpy(lp).to(cuda)
    before = launch_counts()["turbo_half_iter"]
    got = half_iteration(lin, lp, W, 24)
    torch.cuda.synchronize()
    assert launch_counts()["turbo_half_iter"] == before + 1
    # same float32 operations in the same order
    torch.testing.assert_close(got, half_iteration_ref(lin, lp, W, 24),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("A,Qm,n0_kind", [(1, 6, "per_re"), (1, 2, "scalar"),
                                          (2, 4, "per_re"), (2, 6, "full")])
def test_mrc_llr_kernel_matches_plain_version(cuda, A, Qm, n0_kind):
    rng = np.random.default_rng(A * 10 + Qm)
    shape = (3, 700, A)
    y = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    H = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    y, H = torch.from_numpy(y).to(cuda), torch.from_numpy(H).to(cuda)
    n0 = {"scalar": 0.37,
          "per_re": torch.from_numpy(rng.uniform(0.1, 2, 700).astype(
              np.float32)).to(cuda),
          "full": torch.from_numpy(rng.uniform(0.1, 2, (3, 700)).astype(
              np.float32)).to(cuda)}[n0_kind]
    before = launch_counts()["mrc_llr"]
    got = mrc_llr(y, H, n0, Qm)
    torch.cuda.synchronize()
    assert launch_counts()["mrc_llr"] == before + 1
    torch.testing.assert_close(got, mrc_llr_ref(y, H, n0, Qm),
                               rtol=3e-4, atol=3e-4)


def test_kernels_refuse_what_they_do_not_take(cuda):
    y = torch.zeros(4, 3, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError):
        mrc_llr(y, y, 1.0, 8)                       # Qm not built
    with pytest.raises(ValueError):
        mrc_llr(y.t(), y.t(), 1.0, 2)               # not contiguous
    lin = torch.zeros(2, 96, device=cuda)
    with pytest.raises(TypeError):
        half_iteration(lin.double(), lin.double(), 48, 24)


def test_step_on_card_decodes_through_both_kernels(cuda):
    cfg = DlsimFadingConfig(mcs=26, n_rb=25, channel="EVA", n_rx=1,
                            n_harq_rounds=1, batch=8, est_mode="joint",
                            n_turbo_iter=4)
    sim = DlsimFading(cfg, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    W, ev = sim.wiener(30.0), sim.err_var(30.0)
    before = launch_counts()
    res = sim.step(gen, 10.0 ** -3.0, W, ev)
    after = launch_counts()
    assert bool(res.ok.all()) and int(res.bit_errs.sum()) == 0
    assert all(after[k] > before[k] for k in after), (before, after)
