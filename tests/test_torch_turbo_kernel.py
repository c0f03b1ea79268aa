"""The turbo half-iteration of the PyTorch port: its plain version against
the reference's v2 Pallas kernel (interpret mode) and the XLA oracle, and
the wrapper's device rule (the CUDA kernel's own tests are in
test_torch_cuda.py)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openair4g_tpu.ops import turbo as jturbo
from openair4g_tpu.ops.turbo_pallas import (half_iteration_pallas_v2,
                                            prep_parity_v2)
from openair4g_tpu_torch.device import launch_counts
from openair4g_tpu_torch.ops import turbo
from openair4g_tpu_torch.ops.turbo_cuda import (_TABLES, BIG, half_iteration,
                                                half_iteration_ref,
                                                pick_unroll)

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

_SHAPES = [(48, 2), (48, 3), (96, 2), (96, 3)]   # (W, windows), U = 24


def _inputs(W, n_w, seed=0, B=2):
    rng = np.random.default_rng(seed + W + n_w)
    N = W * n_w
    lin = (3.0 * rng.standard_normal((B, N))).astype(np.float32)
    lp = (3.0 * rng.standard_normal((B, N))).astype(np.float32)
    lin[:, -7:] = BIG              # forced pad region past the trellis end
    lp[:, -7:] = BIG
    return lin, lp


@pytest.mark.parametrize("W,n_w", _SHAPES)
def test_ref_matches_pallas_v2_every_node(W, n_w):
    U = 24
    lin, lp = _inputs(W, n_w)
    want = np.asarray(half_iteration_pallas_v2(
        jnp.asarray(lin), prep_parity_v2(jnp.asarray(lp), W, U), W, U,
        interpret=True))
    got = half_iteration_ref(torch.from_numpy(lin), torch.from_numpy(lp),
                             W, U).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("W,n_w", _SHAPES)
def test_ref_matches_xla_oracle_on_interior_nodes(W, n_w):
    """Window-end nodes differ by design (v2's beta there is a U-step
    warm-up, the oracle's the neighbouring window's converged beta)."""
    U = 24
    lin, lp = _inputs(W, n_w, seed=1)
    want = np.asarray(jturbo._half_iteration(jnp.asarray(lin),
                                             jnp.asarray(lp), W, U))
    got = half_iteration_ref(torch.from_numpy(lin), torch.from_numpy(lp),
                             W, U).numpy()
    interior = np.ones(W * n_w, bool)
    interior[np.arange(W - 1, W * n_w, W)] = False
    np.testing.assert_allclose(got[:, interior], want[:, interior],
                               rtol=1e-3, atol=0.05)


def test_closed_form_trellis_matches_table_build():
    """The wiring formulas the kernel and its plain version use equal the
    table build of ops/turbo._trellis (itself equal to the reference's)."""
    np.testing.assert_array_equal(turbo.NEXT_STATE, jturbo.NEXT_STATE)
    np.testing.assert_array_equal(turbo.PARITY, jturbo.PARITY)
    next0, next1, pred0, pred1, sz0, su_p, sz_p = _TABLES
    np.testing.assert_array_equal(next0, turbo.NEXT_STATE[:, 0])
    np.testing.assert_array_equal(next1, turbo.NEXT_STATE[:, 1])
    np.testing.assert_array_equal(sz0, 1 - 2 * turbo.PARITY[:, 0])
    for s in range(8):
        # incoming branch j from pred_j: input and parity flip with j
        for p, sign in ((pred0[s], 1), (pred1[s], -1)):
            u = 0 if sign * su_p[s] > 0 else 1
            assert turbo.NEXT_STATE[p, u] == s
            assert 1 - 2 * turbo.PARITY[p, u] == sign * sz_p[s]


def test_wrapper_takes_plain_version_for_cpu_tensors():
    lin, lp = _inputs(48, 2)
    before = launch_counts()["turbo_half_iter"]
    a = half_iteration(torch.from_numpy(lin), torch.from_numpy(lp), 48, 24)
    b = half_iteration_ref(torch.from_numpy(lin), torch.from_numpy(lp), 48, 24)
    assert torch.equal(a, b)
    assert launch_counts()["turbo_half_iter"] == before


def test_wrapper_rejects_other_devices_and_bad_shapes():
    lin = torch.zeros(2, 96, device="meta")
    with pytest.raises(ValueError):
        half_iteration(lin, lin, 48, 24)
    with pytest.raises(ValueError):
        half_iteration_ref(torch.zeros(2, 100), torch.zeros(2, 100), 48, 24)
    assert pick_unroll(240, 24) == 8 and pick_unroll(44, 20) == 4
