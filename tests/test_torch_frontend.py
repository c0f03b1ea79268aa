"""Symbol and front-end path of the PyTorch port against the JAX reference:
QAM mapping and demapping, grid fill/extract, OFDM, the fading channel,
and joint channel estimation (within 1e-5 relative), plus the host-side
numpy plans copied from the reference (exactly equal)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openair4g_tpu.ops.llr import demap_llr as j_demap, map_symbols as j_map
from openair4g_tpu.phy import channel_est as jce
from openair4g_tpu.phy import ofdm as jofdm
from openair4g_tpu.phy import resource_grid as jrg
from openair4g_tpu.sim import channels as jch
from openair4g_tpu_torch.convert import estimator_state_from_reference
from openair4g_tpu_torch.ops.llr import demap_llr, map_symbols
from openair4g_tpu_torch.phy import channel_est as ce
from openair4g_tpu_torch.phy import ofdm
from openair4g_tpu_torch.phy import resource_grid as rg
from openair4g_tpu_torch.sim import channels as ch

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)


def _close(got, want):
    """|got - want| <= 1e-5 * max|want| (relative to the signal's scale)."""
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= 1e-5 * np.abs(want).max()


def _cplx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


@pytest.mark.parametrize("Qm", [2, 4, 6])
def test_map_and_demap_match_reference(Qm):
    rng = np.random.default_rng(Qm)
    bits = rng.integers(0, 2, (3, 60 * Qm)).astype(np.int32)
    sym = map_symbols(torch.from_numpy(bits), Qm)
    _close(sym.numpy(), j_map(jnp.asarray(bits), Qm))
    y = _cplx(rng, (3, 60))
    n0 = rng.uniform(0.1, 1.0, (3, 60)).astype(np.float32)
    _close(demap_llr(torch.from_numpy(y), torch.from_numpy(n0), Qm).numpy(),
           j_demap(jnp.asarray(y), jnp.asarray(n0), Qm))


@pytest.mark.parametrize("n_rb,n_pdcch", [(6, 2), (25, 1), (100, 1)])
def test_grid_map_equals_reference(n_rb, n_pdcch):
    g, j = rg.make_grid_map(n_rb, n_pdcch), jrg.make_grid_map(n_rb, n_pdcch)
    assert g.n_data_re == j.n_data_re
    for f in ("data_sym", "data_sc", "data_bin", "pilot_sym", "pilot_sc",
              "pilot_bin", "pilot_val", "pilot_port"):
        np.testing.assert_array_equal(getattr(g, f), getattr(j, f))


@pytest.mark.parametrize("n_rb", [6, 25])
def test_fill_extract_and_ofdm_match_reference(n_rb):
    gm, jgm = rg.make_grid_map(n_rb, 1), jrg.make_grid_map(n_rb, 1)
    rng = np.random.default_rng(n_rb)
    sym = _cplx(rng, (2, gm.n_data_re))
    grid = rg.fill_grid(torch.from_numpy(sym), gm)
    jgrid = jrg.fill_grid(jnp.asarray(sym), jgm)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
    np.testing.assert_array_equal(rg.extract_data_res(grid, gm).numpy(), sym)
    t = ofdm.ofdm_modulate(grid, gm.fp)
    jt = jofdm.ofdm_modulate(jgrid, jgm.fp)
    assert t.shape == (2, gm.fp.samples_per_tti)
    _close(t.numpy(), jt)
    back = ofdm.ofdm_demodulate(t, gm.fp)
    _close(back.numpy(), jofdm.ofdm_demodulate(jt, jgm.fp))
    _close(back.numpy(), grid.numpy())


def test_channel_matches_reference_on_injected_taps():
    fp = rg.make_grid_map(25, 1).fp
    cm = ch.ChannelModel("EVA", fp, delay_scale=0.651)
    jcm = jch.ChannelModel(name="EVA", fp=jrg.make_grid_map(25, 1).fp,
                           delay_scale=0.651)
    np.testing.assert_array_equal(cm.amps, jcm.amps)
    np.testing.assert_array_equal(cm.phase_matrix, jcm.phase_matrix)
    normals = np.random.default_rng(4).normal(
        size=(3, 1, 1, cm.n_taps, 2)).astype(np.float32)
    taps = cm.draw_taps(3, normals=torch.from_numpy(normals))
    # the reference draws from keys; feed its formula the same normals
    jtaps = (np.sqrt(jcm.amps / 2.0) * (normals[..., 0] + 1j
                                         * normals[..., 1]))[:, 0, 0]
    _close(taps.numpy(), jtaps)
    H = cm.freq_response(taps)
    jH = jcm.freq_response(jnp.asarray(jtaps.astype(np.complex64)))
    _close(H.numpy(), jH)
    grid = torch.from_numpy(_cplx(np.random.default_rng(5),
                                  (3, 14, fp.n_fft)))
    _close(ch.apply_channel_grid(grid, H, fp).numpy(),
           jch.apply_channel_grid(jnp.asarray(grid.numpy()), jH, fp))


def test_channel_model_rejects_what_is_not_ported():
    fp = rg.make_grid_map(25, 1).fp
    with pytest.raises(NotImplementedError):
        ch.ChannelModel("Rayleigh1_corr", fp, n_tx=2, n_rx=2)
    with pytest.raises(NotImplementedError):
        ch.ChannelModel("Rice1", fp)


@pytest.mark.parametrize("n_rb,snr_db", [(25, 5.0), (25, 20.0), (100, 10.0)])
def test_estimator_plans_equal_reference(n_rb, snr_db):
    gm, jgm = rg.make_grid_map(n_rb, 1), jrg.make_grid_map(n_rb, 1)
    n0 = 10.0 ** (-snr_db / 10.0)
    np.testing.assert_array_equal(ce.make_wiener_joint(gm, n0),
                                  jce.make_wiener_joint(jgm, n0))
    np.testing.assert_array_equal(ce.joint_err_var(gm, n0),
                                  jce.joint_err_var(jgm, n0))
    rgrid = _cplx(np.random.default_rng(n_rb), (3, 14, gm.fp.n_fft))
    prior = ce.measure_delay_prior(rgrid, gm, n0)
    np.testing.assert_array_equal(prior,
                                  jce.measure_delay_prior(rgrid, jgm, n0))
    np.testing.assert_array_equal(
        ce.make_wiener_joint(gm, n0, prior=prior),
        jce.make_wiener_joint(jgm, n0, prior=prior))
    np.testing.assert_array_equal(
        ce.joint_err_var(gm, n0, prior=prior),
        jce.joint_err_var(jgm, n0, prior=prior))


def test_estimate_channel_joint_matches_reference():
    gm, jgm = rg.make_grid_map(25, 1), jrg.make_grid_map(25, 1)
    rgrid = _cplx(np.random.default_rng(6), (3, 14, gm.fp.n_fft))
    w = jce.make_wiener_joint(jgm, 0.1)
    W, _ = estimator_state_from_reference(w, jce.joint_err_var(jgm, 0.1),
                                          "cpu")
    got = ce.estimate_channel_joint(torch.from_numpy(rgrid), gm, W)
    want = jce.estimate_channel_joint(jnp.asarray(rgrid), jgm, w)
    assert got.shape == (3, 14, gm.fp.n_sc)
    _close(got.numpy(), want)
