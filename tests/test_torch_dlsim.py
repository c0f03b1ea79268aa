"""DlsimFading round 0 of the PyTorch port against the JAX reference on the
same draws (TB bits, channel taps, noise), replayed from the reference's
own key splits, with identical estimator matrices (the HARQ rounds and the
other receiver and channel modes: tests/test_torch_dlsim_harq.py).

25 PRB (5 CCEs, so the PDCCH is on), EVA, joint estimation, exp prior,
batch 4, 4 turbo iterations, decoder window 96 on both sides (the CPU
default of each). TB and DCI flags must be equal at a high SNR; the
pre-decoder soft buffers agree to 1e-3 (FFT and matmul sum order) at a
moderate one."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openair4g_tpu.sim.dlsim import DlsimFading as JSim
from openair4g_tpu.sim.dlsim import DlsimFadingConfig as JConfig
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.convert import estimator_state_from_reference
from openair4g_tpu_torch.sim.dlsim import DlsimFading, DlsimFadingConfig

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

B = 4


def _config(mcs):
    return dict(mcs=mcs, n_rb=25, channel="EVA", n_rx=1, n_harq_rounds=1,
                batch=B, est_mode="joint", n_turbo_iter=4, est_prior="exp")


@pytest.fixture(scope="module", params=[4, 26], ids=["mcs4", "mcs26"])
def pair(request):
    cfg = _config(request.param)
    return JSim(JConfig(**cfg)), DlsimFading(DlsimFadingConfig(**cfg),
                                             device="cpu")


def _draws(jsim, seed):
    """The reference's draws for host_keys(seed, B), replayed: the splits
    of DlsimFading._tx_encode, taps from ChannelModel.draw_taps' normals
    and the noise normals of the round function."""
    keys = jnp.asarray(host_keys(seed, B))
    splits = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    tb = jax.vmap(lambda k: jax.random.bernoulli(
        k, 0.5, (jsim.dlsch.cfg.tbs,)))(splits[:, 0]).astype(jnp.int32)
    taps = jax.vmap(lambda k: jax.random.normal(
        k, (1, 1, jsim.chan.n_taps, 2)))(splits[:, 2])
    noise = jax.vmap(lambda k: jax.random.normal(
        k, (1, jsim.fp.samples_per_tti, 2)))(splits[:, 3])
    draws = tuple(torch.from_numpy(np.array(x)) for x in (tb, taps, noise))
    return keys, draws


def _run_both(jsim, sim, snr_db, seed):
    n0 = np.float32(10.0 ** (-snr_db / 10.0))
    Wj, evj = jsim.wiener(snr_db), jsim.err_var(snr_db)
    keys, draws = _draws(jsim, seed)
    d, kc, kn = jsim._tx(keys)
    jok, jw, _, jdci = jsim._round(0)(d, kc[0], kn[0], jnp.float32(n0),
                                      Wj, evj)
    W, ev = estimator_state_from_reference(np.asarray(Wj), np.asarray(evj),
                                           "cpu")
    tb, taps, noise = draws
    res = sim.trial(tb, [taps], [noise], float(n0), W, ev).rounds[0]
    return (np.asarray(jok), np.asarray(jdci), [np.asarray(w) for w in jw]), \
        res, draws


def test_round0_flags_equal_reference_at_high_snr(pair):
    jsim, sim = pair
    (jok, jdci, _), res, draws = _run_both(jsim, sim, 30.0, seed=0)
    np.testing.assert_array_equal(res.ok.numpy(), jok)
    np.testing.assert_array_equal(res.dci_ok.numpy(), jdci)
    assert jok.all() and int(res.bit_errs.sum()) == 0
    assert torch.equal(sim.dlsch.encode(draws[0]),
                       torch.from_numpy(np.array(jsim.dlsch.encode(
                           jnp.asarray(draws[0].numpy())))))


def test_round0_soft_buffers_match_reference(pair):
    jsim, sim = pair
    snr = 6.0 if sim.dlsch.cfg.Qm == 2 else 16.0
    (jok, jdci, jw), res, _ = _run_both(jsim, sim, snr, seed=1)
    np.testing.assert_array_equal(res.dci_ok.numpy(), jdci)
    assert jdci.all()
    assert len(res.w_soft) == len(jw)
    for got, want in zip(res.w_soft, jw):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_estimator_state_conversion():
    W = np.random.default_rng(0).normal(size=(10, 12, 2)).astype(np.float32)
    Wc, ev = estimator_state_from_reference(W, np.ones(7, np.float32), "cpu")
    assert Wc.dtype == torch.complex64 and Wc.shape == (10, 12)
    np.testing.assert_array_equal(Wc.real.numpy(), W[..., 0])
    np.testing.assert_array_equal(Wc.imag.numpy(), W[..., 1])
    assert ev.shape == (7,)
    with pytest.raises(ValueError):
        estimator_state_from_reference(W[..., 0], np.ones(7), "cpu")


@pytest.mark.parametrize("change", [
    dict(est_mode="mmse"), dict(est_prior="flat"), dict(snr_convention="db"),
    dict(channel="SCM_A"), dict(channel="eva"),
    dict(est_mode="dd", intra_doppler_hz=70.0),
    dict(est_mode="interp", intra_doppler_hz=70.0, n_rx=2),
    dict(est_mode="interp", intra_doppler_hz=70.0, time_domain_channel=True),
    dict(est_mode="joint", intra_doppler_hz=5.0, n_rx=2),
    dict(est_mode="dd", intra_doppler_hz=5.0, n_rx=2)])
def test_configs_outside_the_slice_raise(change):
    """What neither simulator runs: unknown estimator, prior, SNR
    convention or channel names, and the intra-subframe Doppler fade with
    2 RX antennas, the time-domain channel or the decision-directed
    estimator (which assumes a channel constant over the subframe)."""
    cfg = {**_config(4), **change}
    with pytest.raises(ValueError):
        DlsimFading(DlsimFadingConfig(**cfg), device="cpu")


def test_step_runs_on_a_cpu_simulator():
    """step draws on the simulator's own device, the CPU here."""
    sim = DlsimFading(DlsimFadingConfig(**_config(4)), device="cpu")
    res = sim.step(torch.Generator().manual_seed(0), 10.0 ** -3.0,
                   sim.wiener(30.0), sim.err_var(30.0))
    assert res.rounds[0].ok.device.type == "cpu"
    assert bool(res.rounds[0].ok.all()) and res.reach.tolist() == [B]
