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
from openair4g_tpu_torch.ops.equalize_llr import (_n0_view, _rows_cols,
                                                  mrc_llr,
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
    """A number stays a number (a kernel argument); a tensor becomes a view
    of the leading shape that the rows x cols split walks without a copy."""
    lead = (4, 5)
    assert _n0_view(0.5, lead, "cpu") == (None, 0.5)
    assert _n0_view(np.float32(0.25), lead, "cpu") == (None, 0.25)
    y_strides = (5, 1)
    for n0, rows_cols, walk in (
            (torch.arange(5.0), (4, 5), (0, 1)),         # one value an RE
            (torch.rand(4, 5), (1, 20), (0, 1)),         # full shape
            (torch.rand(4, 1), (4, 5), (1, 0)),          # one value a row
            (torch.tensor(0.3), (1, 20), (0, 0)),        # a 0-dim tensor
            (torch.rand(4, 10)[:, ::2], (1, 20), (0, 2))):
        view, scalar = _n0_view(n0, lead, "cpu")
        assert scalar == 0.0 and view.shape == lead
        assert view.untyped_storage().data_ptr() \
            == n0.untyped_storage().data_ptr()
        rows, cols, walks = _rows_cols(lead, (y_strides, view.stride()))
        assert (rows, cols) == rows_cols and walks[1] == walk, (n0.shape,
                                                                 walks)


def test_wrapper_rejects_other_devices():
    y = torch.zeros(2, 3, 1, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError):
        mrc_llr(y, y, 1.0, 2)
