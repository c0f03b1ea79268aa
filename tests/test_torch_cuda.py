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
from openair4g_tpu_torch.ops.equalize_llr import (demap_llr_fused,
                                                  demap_llr_fused_ref,
                                                  mrc_llr, mrc_llr_ref)
from openair4g_tpu_torch.ops.turbo_cuda import (BIG, half_iteration,
                                                half_iteration_prepped,
                                                half_iteration_prepped_ref,
                                                half_iteration_ref,
                                                prep_parity)
from openair4g_tpu_torch.sim.dlsim import DlsimFading, DlsimFadingConfig
from openair4g_tpu_torch.sim.dlsim_sm import DlsimSm, DlsimSmConfig

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
    with pytest.raises(ValueError):
        demap_llr_fused(y.t(), 1.0, 2)              # no one element stride
    with pytest.raises(ValueError):
        demap_llr_fused(y, 1.0, 8)                  # Qm not built
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
    assert all(after[k] > before[k] for k in ("turbo_half_iter", "mrc_llr")), \
        (before, after)


@pytest.mark.parametrize("Qm", [2, 4, 6])
@pytest.mark.parametrize("layout", ["contiguous", "layer"])
def test_demap_llr_kernel_matches_plain_version(cuda, Qm, layout):
    """`layer`: x_hat[..., 1] and n0_eff[..., 1] of an MMSE output
    [B, N, 2], read in place at element stride 2."""
    gen = torch.Generator(device=cuda).manual_seed(Qm)
    shape = (3, 700, 2) if layout == "layer" else (3, 700)
    x = torch.view_as_complex(torch.randn(*shape, 2, generator=gen,
                                          device=cuda))
    n0 = 0.05 + torch.rand(*shape, generator=gen, device=cuda)
    if layout == "layer":
        x, n0 = x[..., 1], n0[..., 1]
        assert not x.is_contiguous()
    before = launch_counts()["demap_llr"]
    got = demap_llr_fused(x, n0, Qm)
    torch.cuda.synchronize()
    assert launch_counts()["demap_llr"] == before + 1
    torch.testing.assert_close(got, demap_llr_fused_ref(x, n0, Qm),
                               rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(demap_llr_fused(x, 0.3, Qm),
                               demap_llr_fused_ref(x, 0.3, Qm),
                               rtol=3e-4, atol=3e-4)


def test_demap_llr_kernel_takes_broadcast_n0(cuda):
    """n0_eff as a full-shape view of one value, or of one value per row
    (stride 0), on a strided x_hat layer."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.view_as_complex(torch.randn(3, 700, 2, 2, generator=gen,
                                          device=cuda))[..., 0]
    for n0 in (torch.tensor(0.3, device=cuda).expand_as(x),
               torch.tensor([0.2, 0.5, 1.1], device=cuda)[:, None]
               .expand(3, 700)):
        torch.testing.assert_close(demap_llr_fused(x, n0, 4),
                                   demap_llr_fused_ref(x, n0.contiguous(), 4),
                                   rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("B,W,n_w", [(64, 48, 3), (1408, 240, 24)])
def test_turbo_v1_kernel_matches_plain_version(cuda, B, W, n_w):
    gen = torch.Generator(device=cuda).manual_seed(W)
    lin = 3.0 * torch.randn(B, W * n_w, generator=gen, device=cuda)
    lp = 3.0 * torch.randn(B, W * n_w, generator=gen, device=cuda)
    lin[:, -7:] = BIG
    lp[:, -7:] = BIG
    gpf, gpb = prep_parity(lp, W, 24)
    before = launch_counts()["turbo_half_iter_v1"]
    got = half_iteration_prepped(lin, gpf, gpb, W, 24)
    torch.cuda.synchronize()
    assert launch_counts()["turbo_half_iter_v1"] == before + 1
    # same float32 operations in the same order
    torch.testing.assert_close(
        got, half_iteration_prepped_ref(lin, gpf, gpb, W, 24),
        rtol=0, atol=1e-4)


def test_tm3_step_on_card_goes_through_demap_kernel(cuda):
    sim = DlsimSm(DlsimSmConfig(tm=3, mcs=16, mcs2=16, n_rb=25, batch=8,
                                n_turbo_iter=4), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    W0, W1 = sim.wiener(40.0)
    before = launch_counts()
    res = sim.step(gen, 1e-4, W0, W1)
    after = launch_counts()
    assert bool(res.dci_ok.all())
    assert res.ok.shape == (2, 8)
    # two layers and the PDCCH
    assert after["demap_llr"] == before["demap_llr"] + 3, (before, after)
    assert after["turbo_half_iter"] > before["turbo_half_iter"]
