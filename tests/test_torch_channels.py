"""The channel catalog and the decision-directed estimator of the PyTorch
port against the JAX reference on the same inputs: tap draws of every
PROFILES model on the reference's own normals (replayed from its keys),
the AR(1) evolution, the time-domain FIR path and the per-symbol Jakes
fade within 1e-5 of the signal's scale, the Doppler helpers to 1e-9, and
pdp_prior, qam_hard_slice (exact), make_dd_smoother (1e-6) and dd_refine
(1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.config import FrameParms as JFrameParms
from openair4g_tpu.phy import channel_est as jce
from openair4g_tpu.phy import resource_grid as jrg
from openair4g_tpu.sim import channels as jch
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.config import FrameParms
from openair4g_tpu_torch.phy import channel_est as ce
from openair4g_tpu_torch.phy import resource_grid as rg
from openair4g_tpu_torch.sim import channels as ch

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

B = 3


def _close(got, want, rel=1e-5):
    """|got - want| <= rel * max|want| (relative to the signal's scale)."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _t(x):
    return torch.from_numpy(np.array(x))


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _models(name, n_tx, n_rx, n_rb=25, delay_scale=1.0):
    return (ch.ChannelModel(name, FrameParms(n_rb=n_rb), n_tx=n_tx,
                            n_rx=n_rx, delay_scale=delay_scale),
            jch.ChannelModel(name=name, fp=JFrameParms(n_rb=n_rb), n_tx=n_tx,
                             n_rx=n_rx, delay_scale=delay_scale))


def _replayed_normals(jcm, keys):
    """The normals the reference's draw_taps takes from `keys`, and the
    random-AoA normal it takes from the same keys (Rice1, Rice8)."""
    n = jax.vmap(lambda k: jax.random.normal(
        k, (jcm.n_rx, jcm.n_tx, jcm.n_taps, 2)))(keys)
    if jcm.ricean[2]:
        u = jax.vmap(lambda k: jax.random.normal(k, (1,)))(keys)[:, 0]
        return _t(n), _t(u)
    return _t(n)


def test_bessel_j0_with_trapezoid_equals_reference():
    x = np.linspace(0.0, 40.0, 257)
    np.testing.assert_array_equal(ch.bessel_j0(x), jch.bessel_j0(x))


@pytest.mark.parametrize("fd", [0.0, 5.0, 10.0, 70.0, 300.0])
def test_doppler_factors_match_reference(fd):
    assert abs(ch.jakes_rho(fd, 1e-3) - jch.jakes_rho(fd, 1e-3)) <= 1e-9
    assert abs(ch.harq_forgetting_factor(fd)
               - jch.harq_forgetting_factor(fd)) <= 1e-9


@pytest.mark.parametrize("name", sorted(jch.PROFILES))
@pytest.mark.parametrize("n_tx,n_rx", [(1, 1), (1, 2), (2, 2), (2, 1)])
def test_tap_draw_of_every_model_matches_reference(name, n_tx, n_rx):
    cm, jcm = _models(name, n_tx, n_rx)
    np.testing.assert_array_equal(cm.amps, jcm.amps)
    np.testing.assert_array_equal(cm.phase_matrix, jcm.phase_matrix)
    assert cm.ricean == jcm.ricean
    rs, jrs = cm.r_sqrt_stack, jcm.r_sqrt_stack
    assert (rs is None) == (jrs is None)
    if rs is not None:
        np.testing.assert_array_equal(rs, jrs)
    keys = jnp.asarray(host_keys(7, B))
    want = np.asarray(jcm.draw_taps(keys, B))
    normals = None if name == "AWGN" else _replayed_normals(jcm, keys)
    got = cm.draw_taps(B, normals=normals)
    assert got.shape == want.shape and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    _close(cm.freq_response(got).numpy(),
           jcm.freq_response(jnp.asarray(want)))


def test_awgn_makes_no_draw_and_passes_the_signal():
    cm, _ = _models("AWGN", 1, 2)
    assert cm.draw_normals(B) is None
    taps = cm.draw_taps(B)
    assert torch.equal(taps, torch.ones(B, 2, 1, 1, dtype=torch.complex64))
    assert torch.equal(cm.freq_response(taps[:, :, 0]),
                       torch.ones(B, 2, 300, dtype=torch.complex64))
    t = torch.from_numpy(_cplx(np.random.default_rng(1), B, 500))
    assert ch.apply_channel_time(t, cm, taps[:, 0, 0]) is t


def test_random_aoa_models_need_the_aoa_normals_off_siso():
    cm, _ = _models("Rice1", 1, 2)
    n, u = cm.draw_normals(B, torch.Generator().manual_seed(0))
    assert n.shape == (B, 2, 1, 1, 2) and u.shape == (B,)
    with pytest.raises(ValueError):
        cm.draw_taps(B, normals=n)
    siso, _ = _models("Rice1", 1, 1)
    assert siso.draw_taps(B, normals=n[:, :1]).shape == (B, 1)


@pytest.mark.parametrize("name,n_rx", [("EVA", 1), ("ETU", 2), ("Rice8", 2)])
def test_evolve_taps_matches_reference(name, n_rx):
    cm, jcm = _models(name, 1, n_rx)
    keys = jnp.asarray(host_keys(8, B))
    prev = jcm.draw_taps(jnp.asarray(host_keys(9, B)), B)
    ff = jch.harq_forgetting_factor(10.0)
    want = np.asarray(jcm.evolve_taps(prev, keys, ff=ff))
    got = cm.evolve_taps(_t(prev), _replayed_normals(jcm, keys), ff)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,n_rb,scale", [("ETU", 25, 1.0),
                                             ("EVA", 6, 0.651),
                                             ("SCM_C", 25, 1.0)])
def test_time_domain_fir_path_matches_reference(name, n_rb, scale):
    cm, jcm = _models(name, 1, 1, n_rb, scale)
    np.testing.assert_array_equal(ch._fir_sinc_matrix(cm),
                                  jch._fir_sinc_matrix(jcm))
    taps = jcm.draw_taps(jnp.asarray(host_keys(10, B)), B)
    _close(ch.fir_freq_response(cm, _t(taps)).numpy(),
           jch.fir_freq_response(jcm, taps))
    t = _cplx(np.random.default_rng(n_rb), B, cm.fp.samples_per_tti)
    _close(ch.apply_channel_time(_t(t), cm, _t(taps)).numpy(),
           jch.apply_channel_time(jnp.asarray(t), jcm, taps))


@pytest.mark.parametrize("name,fd", [("EVA", 200.0), ("ETU", 70.0),
                                     ("AWGN", 300.0)])
def test_timevar_fade_matches_reference(name, fd):
    cm, jcm = _models(name, 1, 1)
    fp, jfp = cm.fp, jcm.fp
    np.testing.assert_array_equal(ch.symbol_center_times(fp),
                                  jch.symbol_center_times(jfp))
    np.testing.assert_array_equal(ch.jakes_symbol_corr_sqrt(25, fd),
                                  jch.jakes_symbol_corr_sqrt(25, fd))
    keys = jnp.asarray(host_keys(11, B))
    want = jch.draw_taps_timevar(jcm, keys, B, fd)
    normals = None if name == "AWGN" else _t(jax.vmap(
        lambda k: jax.random.normal(k, (14, jcm.n_taps, 2)))(keys))
    got = ch.draw_taps_timevar(cm, B, fd, normals=normals)
    _close(got.numpy(), want)
    grid = _cplx(np.random.default_rng(12), B, 14, fp.n_fft)
    g, H = ch.apply_channel_grid_timevar(_t(grid), cm, got, fp)
    jg, jH = jch.apply_channel_grid_timevar(jnp.asarray(grid), jcm, want,
                                            jfp)
    _close(H.numpy(), jH)
    _close(g.numpy(), jg)


# ------------------------------------------ decision-directed estimator --

@pytest.mark.parametrize("name,scale", [("EVA", 0.651), ("ETU", 1.0),
                                        ("Rayleigh8", 1.0), ("AWGN", 1.0)])
def test_pdp_prior_equals_reference(name, scale):
    delays, amps_db = jch.PROFILES[name]
    amps = 10.0 ** (0.1 * np.asarray(amps_db))
    np.testing.assert_array_equal(
        ce.pdp_prior(FrameParms(n_rb=50), delays, amps, scale),
        jce.pdp_prior(JFrameParms(n_rb=50), delays, amps, scale))


@pytest.mark.parametrize("Qm", [2, 4, 6])
def test_qam_hard_slice_is_exact(Qm):
    x = _cplx(np.random.default_rng(Qm), 4000) * 0.6
    got = ce.qam_hard_slice(_t(x), Qm).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jce.qam_hard_slice(jnp.asarray(x), Qm)))
    assert len(np.unique(got.real)) == 2 ** (Qm // 2)


@pytest.mark.parametrize("n_rb,n_pdcch", [(25, 1), (6, 3)])
def test_dd_smoother_and_refine_match_reference(n_rb, n_pdcch):
    gm, jgm = rg.make_grid_map(n_rb, n_pdcch), jrg.make_grid_map(n_rb,
                                                                 n_pdcch)
    prior = ce.pdp_prior(gm.fp, *jch.PROFILES["EVA"])
    W, post = ce.make_dd_smoother(gm, 0.05, prior=prior)
    jW, jpost = jce.make_dd_smoother(jgm, 0.05, prior=prior)
    np.testing.assert_allclose(W, jW, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(post, jpost, rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(n_rb)
    y = _cplx(rng, 2, gm.n_data_re)
    s = np.asarray(jce.qam_hard_slice(jnp.asarray(_cplx(rng, 2,
                                                        gm.n_data_re)), 4))
    w = rng.uniform(0.0, 1.0, (2, gm.n_data_re)).astype(np.float32)
    rgrid = _cplx(rng, 2, 14, gm.fp.n_fft)
    Wc = torch.complex(_t(W[..., 0]), _t(W[..., 1]))
    for kw, jkw in (({}, {}),
                    (dict(weight=_t(w), rgrid=_t(rgrid)),
                     dict(weight=jnp.asarray(w), rgrid=jnp.asarray(rgrid)))):
        got = ce.dd_refine(_t(y), _t(s), gm, Wc, **kw)
        want = jce.dd_refine(jnp.asarray(y), jnp.asarray(s), jgm,
                             (jnp.asarray(jW), None), **jkw)
        assert got.shape == (2, gm.fp.n_sc)
        _close(got.numpy(), want, rel=1e-4)
