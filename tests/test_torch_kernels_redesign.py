"""What the v1 turbo kernel and the mrc_llr / demap_llr kernels of the
PyTorch port rest on, as far as the CPU reaches: the v1 kernel's order of
work replayed in plain PyTorch against its plain version and the
reference's Pallas v1 kernel (interpret mode), the read-once claim on the
frames, and the wrappers' decisions (rows x cols split, kernel instance,
what raises). The kernels' own tests are in test_torch_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openair4g_tpu.ops.turbo_pallas import half_iteration_pallas
from openair4g_tpu_torch.device import launch_counts
from openair4g_tpu_torch.ops.equalize_llr import (_n0_view, _rows_cols,
                                                  _split, demap_llr_fused,
                                                  mrc_llr, mrc_llr_ref)
from openair4g_tpu_torch.ops.turbo_cuda import (
    BIG, _frames, _half_iteration_prepped_ckpt_ref, half_iteration_prepped,
    half_iteration_prepped_ref, pick_unroll, prep_parity, scratch_numel)

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)


def _turbo_inputs(B, W, n_w, seed):
    rng = np.random.default_rng(seed)
    lin = (3.0 * rng.standard_normal((B, W * n_w))).astype(np.float32)
    lp = (3.0 * rng.standard_normal((B, W * n_w))).astype(np.float32)
    lin[:, -7:] = BIG              # forced pad region past the trellis end
    lp[:, -7:] = BIG
    return torch.from_numpy(lin), torch.from_numpy(lp)


# ------------------------------------------------------------ turbo v1 --

@pytest.mark.parametrize("W,n_w,U,R", [(48, 2, 24, 8), (48, 3, 24, 8),
                                       (96, 3, 24, 8), (240, 3, 24, 8),
                                       (48, 1, 48, 8), (44, 3, 20, 4),
                                       (42, 3, 18, 2), (45, 3, 15, 1)])
def test_v1_kernel_schedule_equals_plain_version(W, n_w, U, R):
    """The v1 kernel's order of work (a beta checkpoint every R nodes, the
    one at node W taken before the warm-up's last renormalization; each
    block's betas recomputed ahead of its LLRs; lin read in place, a main
    position's parity from gpb alone) gives the plain version's float32
    results exactly."""
    assert pick_unroll(W, U) == R
    lin, lp = _turbo_inputs(3, W, n_w, seed=W + n_w)
    gpf, gpb = prep_parity(lp, W, U)
    assert torch.equal(_half_iteration_prepped_ckpt_ref(lin, gpf, gpb, W, U),
                       half_iteration_prepped_ref(lin, gpf, gpb, W, U))


@pytest.mark.parametrize("B,W,n_w", [(2, 48, 2), (2, 48, 3), (3, 96, 3)])
def test_v1_kernel_schedule_matches_pallas_v1(B, W, n_w):
    U = 24
    lin, lp = _turbo_inputs(B, W, n_w, seed=7 + W + n_w)
    want = np.asarray(half_iteration_pallas(
        jnp.asarray(lin.numpy()), jnp.asarray(lp.numpy()), W, U,
        interpret=True))
    gpf, gpb = prep_parity(lp, W, U)
    got = _half_iteration_prepped_ckpt_ref(lin, gpf, gpb, W, U).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("W,n_w,U", [(48, 3, 24), (240, 2, 24), (44, 3, 20)])
def test_forward_frame_rows_repeat_the_backward_frame(W, n_w, U):
    """Fwd-frame row U + tau and bwd-frame row tau hold the same position
    w*W + tau for lin and for the parity (no pad lies inside a window), so
    the kernel reads a main position once, from the bwd frame; the bwd
    frame's tail is the next window's head and BIG at the last window."""
    lin, lp = _turbo_inputs(2, W, n_w, seed=3)
    for g in (lin, lp):
        fwd, bwd = _frames(0.5 * g, W, U, BIG)
        assert fwd.shape == bwd.shape == (W + U, 2 * n_w)
        assert torch.equal(fwd[U:], bwd[:W])
        rows = (0.5 * g).reshape(2 * n_w, W)
        assert torch.equal(bwd[:W].t(), rows)
        head = bwd[W:].t().reshape(2, n_w, U)
        assert torch.equal(head[:, :-1], rows.reshape(2, n_w, W)[:, 1:, :U])
        assert bool((head[:, -1] == BIG).all())
        assert bool((fwd[:U].t().reshape(2, n_w, U)[:, 0] == 0).all())


def test_v1_scratch_is_one_checkpoint_per_block():
    # the flagship: 1,408 rows of 24 windows, W = 240, U = 24
    assert scratch_numel(1408 * 24, 240, 24) * 4 == 32_440_320 < 45e6


def test_v1_wrapper_takes_plain_version_on_cpu_and_rejects_the_rest():
    lin, lp = _turbo_inputs(2, 48, 2, seed=0)
    gpf, gpb = prep_parity(lp, 48, 24)
    before = launch_counts()["turbo_half_iter_v1"]
    assert torch.equal(half_iteration_prepped(lin, gpf, gpb, 48, 24),
                       half_iteration_prepped_ref(lin, gpf, gpb, 48, 24))
    assert launch_counts()["turbo_half_iter_v1"] == before
    with pytest.raises(ValueError):
        half_iteration_prepped(lin.to("meta"), gpf, gpb, 48, 24)
    with pytest.raises(ValueError):
        half_iteration_prepped_ref(lin, gpf[:-1], gpb, 48, 24)


# ----------------------------------------------- mrc_llr and demap_llr --

def _cplx(rng, *shape):
    return torch.from_numpy((rng.normal(size=shape) + 1j * rng.normal(
        size=shape)).astype(np.complex64))


@pytest.mark.parametrize("lead,strides,want", [
    # contiguous [B, N] (elements of [B, N, A], A = 2): one run of REs
    ((128, 13800), [(27600, 2)], (1, 128 * 13800, ((0, 2),))),
    # [B, A, N] planes seen as [B, N]: a row a batch entry
    ((128, 13800), [(27600, 1)], (128, 13800, ((27600, 1),))),
    # planes at A = 1 collapse to one run
    ((128, 756), [(756, 1)], (1, 128 * 756, ((0, 1),))),
    # y contiguous, n0 one value an RE of a row: the period becomes cols
    ((128, 15000), [(15000, 1), (0, 1)], (128, 15000, ((15000, 1), (0, 1)))),
    # one value a row
    ((4, 6), [(6, 1), (1, 0)], (4, 6, ((6, 1), (1, 0)))),
    # three leading dims, n0 over the last two
    ((2, 3, 700), [(2100, 700, 1), (0, 700, 1)],
     (2, 2100, ((2100, 1), (0, 1)))),
    # one layer of an MMSE output [B, N, 2]
    ((64, 14400), [(28800, 2), (28800, 2)], (1, 64 * 14400, ((0, 2),) * 2)),
    # a 0-dim operand
    ((), [()], (1, 1, ((0, 0),))),
    # cropped in two dims: no split walks it
    ((4, 3, 5), [(48, 8, 1)], None),
    # y walks as one run but n0 (one value per middle entry) does not
    ((2, 3, 4), [(12, 4, 1), (0, 1, 0)], None)])
def test_rows_cols_split(lead, strides, want):
    assert _rows_cols(lead, tuple(strides)) == want


def test_split_materializes_an_n0_no_split_walks_and_raises_on_the_rest():
    n0 = torch.rand(3)[None, :, None].expand(2, 3, 4)
    split, used = _split("t", (2, 3, 4), ((12, 4, 1),), n0)
    assert split[:2] == (1, 24) and used.is_contiguous()
    assert torch.equal(used, n0)
    split, used = _split("t", (2, 3, 4), ((12, 4, 1),), None)
    assert split[:2] == (1, 24) and used is None
    with pytest.raises(ValueError):
        _split("t", (4, 3, 5), ((48, 8, 1),), None)
    with pytest.raises(ValueError):          # cols past the 32-bit RE index
        _split("t", (2 ** 30 + 2,), ((1,),), None)
    with pytest.raises(ValueError):          # the same with an n0 tensor
        _split("t", (2 ** 30 + 2,), ((1,),),
               torch.zeros(1).expand(2 ** 30 + 2))


def test_n0_on_another_device_than_the_operands_raises():
    with pytest.raises(ValueError):
        _n0_view(torch.empty(5, device="meta"), (4, 5), "cpu")


@pytest.mark.parametrize("n0,lead,want", [
    (0.37, (128, 756), (1, 128 * 756)),            # a number: one run of REs
    ("re", (128, 15000), (128, 15000)),            # one value an RE of a row
    ("full", (128, 15000), (1, 128 * 15000)),
    ("row", (4, 6), (4, 6)),
    ("0d", (4, 6), (1, 24))])
def test_n0_period_becomes_the_grid_rows(n0, lead, want):
    """What the wrapper hands the kernel for each kind of n0 with a
    contiguous y: a number stays a number and the REs are one run; a per-RE
    n0 of period N makes N the cols and the batch the rows (no modulo in
    the kernel); nothing is copied."""
    given = {"re": torch.rand(lead[-1]), "full": torch.rand(*lead),
             "row": torch.rand(lead[0], 1), "0d": torch.tensor(0.3)}.get(n0,
                                                                         n0)
    view, scalar = _n0_view(given, lead, "cpu")
    y_strides = (lead[1], 1)
    if view is None:
        assert scalar == pytest.approx(0.37)
    else:
        assert view.data_ptr() == given.data_ptr()
    split, used = _split("t", lead, (y_strides, y_strides), view)
    assert split[:2] == want and used is view


@pytest.mark.parametrize("Qm", [2, 4, 6])
@pytest.mark.parametrize("A", [1, 2])
def test_mrc_llr_takes_antenna_planes_as_strided_views(A, Qm):
    """[B, A, N] planes given as transposed views (what the 1x2 receiver
    passes) give the contiguous [B, N, A] call's LLRs, with a number, a
    per-RE and a full-shape n0. On the CPU the plain version's complex
    products round differently at the two layouts (vectorized or not), so
    the two agree to float32 rounding; on the card the kernel's per-RE
    arithmetic is the same and test_torch_cuda.py holds them equal."""
    rng = np.random.default_rng(A + Qm)
    y, H = _cplx(rng, 3, A, 50), _cplx(rng, 3, A, 50)
    for n0 in (0.37, torch.rand(50) + 0.1, torch.rand(3, 50) + 0.1):
        views = mrc_llr(y.transpose(1, 2), H.transpose(1, 2), n0, Qm)
        assert not y.transpose(1, 2).is_contiguous() or A == 1
        want = mrc_llr(y.transpose(1, 2).contiguous(),
                       H.transpose(1, 2).contiguous(), n0, Qm)
        assert views.shape == (3, 50, Qm) and views.is_contiguous()
        torch.testing.assert_close(views, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(views, mrc_llr_ref(y.transpose(1, 2),
                                              H.transpose(1, 2), n0, Qm))


def test_wrappers_reject_other_devices_types_and_shapes():
    y = torch.zeros(2, 3, 1, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError):
        mrc_llr(y, y, 1.0, 2)
    with pytest.raises(ValueError):
        demap_llr_fused(y, 1.0, 2)
    before = launch_counts()
    x = torch.zeros(2, 8, dtype=torch.complex64)
    demap_llr_fused(x, 0.5, 2)
    mrc_llr(x[..., None], x[..., None], 0.5, 2)
    assert launch_counts() == before
