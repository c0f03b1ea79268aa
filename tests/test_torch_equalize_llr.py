"""Fused MRC/LLR of the PyTorch port against the reference's Pallas kernel
(interpret mode) and its two-stage oracle, tolerances as in
tests/test_equalize_llr.py (the CUDA kernel's own tests are in
test_torch_cuda.py)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openair4g_tpu.ops.equalize_llr import mrc_llr_pallas
from openair4g_tpu.ops.llr import demap_llr as j_demap_llr
from openair4g_tpu.phy.equalize import mrc_equalize as j_mrc_equalize
from openair4g_tpu_torch.device import launch_counts
from openair4g_tpu_torch.ops.equalize_llr import (_n0_operand, mrc_llr,
                                                  mrc_llr_ref)

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

TOL = dict(rtol=3e-4, atol=3e-4)


def _inputs(A, seed, B=3, R=700):          # R: no multiple of any tile
    rng = np.random.default_rng(seed)

    def cplx():
        return (rng.normal(size=(B, R, A))
                + 1j * rng.normal(size=(B, R, A))).astype(np.complex64)
    return cplx(), cplx(), rng.uniform(0.1, 2.0, size=(B, R)).astype(
        np.float32)


@pytest.mark.parametrize("n0_kind", ["scalar", "per_re"])
@pytest.mark.parametrize("Qm", [2, 4, 6])
@pytest.mark.parametrize("A", [1, 2])
def test_matches_pallas_and_two_stage_oracle(A, Qm, n0_kind):
    y, H, n0v = _inputs(A, 10 * Qm + A)
    n0 = 0.37 if n0_kind == "scalar" else n0v
    jn0 = n0 if n0_kind == "scalar" else jnp.asarray(n0)
    pallas = np.asarray(mrc_llr_pallas(jnp.asarray(y), jnp.asarray(H), jn0,
                                       Qm, interpret=True))
    x_hat, n0_eff = j_mrc_equalize(jnp.asarray(y), jnp.asarray(H), jn0)
    oracle = np.asarray(j_demap_llr(x_hat, n0_eff, Qm))
    tn0 = n0 if n0_kind == "scalar" else torch.from_numpy(n0)
    ref = mrc_llr_ref(torch.from_numpy(y), torch.from_numpy(H), tn0, Qm)
    got = mrc_llr(torch.from_numpy(y), torch.from_numpy(H), tn0, Qm)
    assert got.shape == (3, 700, Qm) and got.dtype == torch.float32
    np.testing.assert_allclose(ref.numpy(), pallas, **TOL)
    np.testing.assert_allclose(ref.numpy(), oracle, **TOL)
    assert torch.equal(got, ref)


def test_n0_operand_broadcasts_without_copy_where_it_can():
    lead = (4, 5)
    assert _n0_operand(0.5, lead, "cpu").shape == (1,)
    per_re = torch.arange(5.0)
    op = _n0_operand(per_re, lead, "cpu")            # period 5: no copy
    assert op.shape == (5,) and torch.equal(op, per_re)
    full = torch.rand(4, 5)
    assert torch.equal(_n0_operand(full, lead, "cpu"), full.reshape(-1))
    col = torch.rand(4, 1)                           # not trailing: expand
    assert torch.equal(_n0_operand(col, lead, "cpu"),
                       col.expand(4, 5).reshape(-1))


def test_wrapper_rejects_other_devices():
    y = torch.zeros(2, 3, 1, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError):
        mrc_llr(y, y, 1.0, 2)
