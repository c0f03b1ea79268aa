"""Measurements, tracking, the TDD tables and the RF impairments of the
PyTorch port against the JAX reference on the same inputs (phase noise on
the reference's normals, replayed from its key).

Integer results (CQI indices, TDD masks, timing steps) must be equal;
soft values are held within the float32 tolerance stated at each
check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.phy import measurements as jme
from openair4g_tpu.phy import resource_grid as jrg
from openair4g_tpu.phy import scfdma as jsc
from openair4g_tpu.phy import tdd as jtdd
from openair4g_tpu.phy import tracking as jtr
from openair4g_tpu.sim import rf as jrf
from openair4g_tpu_torch.config import FrameParms
from openair4g_tpu_torch.phy import measurements as me
from openair4g_tpu_torch.phy import resource_grid as rg
from openair4g_tpu_torch.phy import scfdma as sc
from openair4g_tpu_torch.phy import tdd
from openair4g_tpu_torch.phy import tracking as tr
from openair4g_tpu_torch.sim import rf

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

RNG = np.random.default_rng(83)


def _cplx(*shape):
    return (RNG.standard_normal(shape)
            + 1j * RNG.standard_normal(shape)).astype(np.complex64)


def _close(got, want, tol):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                     1e-30)
    assert err < tol, err


@pytest.mark.parametrize("n_rb", [6, 25])
def test_measure_equals_reference(n_rb):
    """rsrp, rssi, rsrq, n0_hat and snr_hat within 1e-5 of their scale."""
    gm, jgm = rg.make_grid_map(n_rb, 1, 3, 2), jrg.make_grid_map(n_rb, 1, 3, 2)
    grid = _cplx(4, 14, gm.fp.n_fft)
    H = _cplx(4, 14, gm.fp.n_sc)
    got = me.measure(torch.from_numpy(grid), gm, H_hat=torch.from_numpy(H))
    want = jme.measure(jnp.asarray(grid), jgm, H_hat=jnp.asarray(H))
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k].numpy(), want[k], 1e-5)
    assert sorted(me.measure(torch.from_numpy(grid), gm)) == \
        ["rsrp", "rsrq", "rssi_per_sc"]


def test_wideband_cqi_equals_reference():
    """Equal indices over SNRs from -10 to 40 dB, the float32 table both
    sides compare with, and points 1e-5 in efficiency on either side of
    each boundary. (On a boundary itself the float32 logarithms of the two
    libraries can differ in the last bit, and the decision with them.)"""
    np.testing.assert_array_equal(
        torch.as_tensor(me._CQI_EFF, dtype=torch.float32).numpy(),
        np.asarray(jnp.asarray(jme._CQI_EFF)))
    edge = me._CQI_EFF[1:] / 0.9
    eff = np.concatenate([edge * (1 - 1e-5), edge * (1 + 1e-5)])
    snr = np.concatenate([2.0 ** eff - 1.0,
                          10.0 ** np.linspace(-1.0, 4.0, 4000)]
                         ).astype(np.float32)
    got = me.wideband_cqi(torch.from_numpy(snr)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jme.wideband_cqi(jnp.asarray(snr))))
    assert (got[16:32] - got[:16] == 1).all()
    assert got.min() == 0 and got.max() == 16


def test_enb_measure_ul_equals_reference():
    pm, jpm = sc.make_pusch_map(25, 12, 0), jsc.make_pusch_map(25, 12, 0)
    grid = 0.1 * _cplx(2, 14, 512)
    grid[:, :, pm.fp.sc_to_bin(np.arange(144))] += 1.0
    for n_used in (12, 25):
        mask = np.arange(25) < n_used
        got = me.enb_measure_ul(torch.from_numpy(grid), pm, mask)
        want = jme.enb_measure_ul(jnp.asarray(grid), jpm, mask)
        for k in got:
            _close(got[k].numpy(), want[k], 1e-5)
    assert (got["n0_hat"].numpy() == 0).all()


def test_tracking_equals_reference():
    fp = FrameParms(n_rb=25)
    f = np.arange(300) - 150
    H = np.stack([np.exp(-2j * np.pi * f * d / fp.n_fft)
                  for d in (0.0, 5.0, -5.0, 12.5)]).astype(np.complex64)
    H += 0.05 * _cplx(*H.shape)
    off, gate = tr.timing_gate(torch.from_numpy(H), fp.cp, fp.n_fft)
    joff, jgate = jtr.timing_gate(jnp.asarray(H), fp.cp, fp.n_fft)
    assert np.abs(off.numpy() - np.asarray(joff)).max() < 1e-4
    np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))
    rx, est = np.array([100, 100, 100, 7]), np.array([3.0, -3.0, 0.1, 0.5],
                                                     np.float32)
    np.testing.assert_array_equal(
        tr.track_timing(torch.from_numpy(rx), torch.from_numpy(est)).numpy(),
        np.asarray(jtr.track_timing(jnp.asarray(rx), jnp.asarray(est))))
    rssi = np.array([4.0, 0.0, 0.3], np.float32)
    _close(tr.agc_gain(torch.from_numpy(rssi)).numpy(),
           jtr.agc_gain(jnp.asarray(rssi)), 1e-6)
    h0, h1 = _cplx(3, 72), _cplx(3, 72)
    _close(tr.pilot_cfo_estimate(torch.from_numpy(h0), torch.from_numpy(h1),
                                 4, 128, 9).numpy(),
           jtr.pilot_cfo_estimate(jnp.asarray(h0), jnp.asarray(h1), 4, 128,
                                  9), 1e-5)


def test_tdd_tables_equal_reference():
    assert tdd.TDD_PATTERNS == jtdd.TDD_PATTERNS
    assert tdd.SPECIAL_SUBFRAME == jtdd.SPECIAL_SUBFRAME
    for cfg in (None, 0, 1, 2, 3, 4, 5, 6):
        np.testing.assert_array_equal(tdd.direction_mask(cfg),
                                      jtdd.direction_mask(cfg))
        assert tdd.dl_subframes(cfg) == jtdd.dl_subframes(cfg)
        assert tdd.ul_subframes(cfg) == jtdd.ul_subframes(cfg)
    for ssf in range(9):
        assert tdd.special_symbols(ssf) == jtdd.special_symbols(ssf)


def test_rf_impairments_equal_reference():
    """IQ imbalance, DAC (exact roundings) and CFO within 1e-6; phase
    noise on the reference's normals within 1e-5 (its cumulative sum runs
    in another order)."""
    t = _cplx(2, 1000)
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    _close(rf.iq_imbalance(tt, 0.1).numpy(), jrf.iq_imbalance(jt, 0.1), 1e-6)
    _close(rf.iq_imbalance_full(tt, 1.5, 4.0).numpy(),
           jrf.iq_imbalance_full(jt, 1.5, 4.0), 1e-6)
    for bits in (4, 12):
        np.testing.assert_array_equal(rf.dac(tt, bits).numpy(),
                                      np.asarray(jrf.dac(jt, bits)))
    _close(rf.cfo(tt, 1.5, 128).numpy(), jrf.cfo(jt, 1.5, 128), 1e-5)
    key = jax.random.PRNGKey(4)
    normals = torch.from_numpy(np.array(jax.random.normal(key, t.shape)))
    got = rf.phase_noise(normals, tt, 100.0, 7.68e6).numpy()
    _close(got, jrf.phase_noise(key, jt, 100.0, 7.68e6), 1e-5)
    np.testing.assert_allclose(np.abs(got), np.abs(t), rtol=1e-5)
