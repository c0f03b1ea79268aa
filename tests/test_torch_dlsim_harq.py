"""The SISO-transmit downlink simulator as a whole: DlsimFading of the
PyTorch port, round by round, against the JAX simulator's `_tx` and
`_round` programs on the same draws (TB bits; per round the channel and
noise normals), replayed from the reference's own key splits, with the
reference's estimator state converted (convert.py). And DlsimAwgn.trial
against the reference's `_trial_step`.

25 PRB (5 CCEs, so the PDCCH is on), batch 4, 4 turbo iterations, decoder
window 96 on both sides, in each receiver/channel mode the port added: the
decision-directed 1x2 receiver over 4 HARQ rounds, interp on AWGN, the
time-domain FIR channel, the per-symbol Jakes fade, the AR(1) fade across
HARQ rounds, and the genie channel with 1x2 MRC.

At 30 dB, TB flags, DCI flags and per-round errs/reach must be equal. At a
moderate SNR, where round 0 fails for some trials and the later rounds
decode soft-combined buffers, the flags must still be equal and, outside
"dd", every round's soft buffers agree to 1e-3 of their scale (FFT and
matmul sum order, amplified by 1/n0). "dd" makes hard decisions on the
first-pass estimate, which a rounding difference can flip on an RE near a
boundary, so there only the flags and per-round error counts are held."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.sim.dlsim import DlsimAwgn as JAwgn
from openair4g_tpu.sim.dlsim import DlsimConfig as JAwgnConfig
from openair4g_tpu.sim.dlsim import DlsimFading as JSim
from openair4g_tpu.sim.dlsim import DlsimFadingConfig as JConfig
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.convert import estimator_state_from_reference
from openair4g_tpu_torch.sim.dlsim import (DlsimAwgn, DlsimConfig,
                                           DlsimFading, DlsimFadingConfig)

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

B = 4
COMMON = dict(n_rb=25, batch=B, n_turbo_iter=4)
# mode: (config, moderate SNR in dB)
MODES = {
    "dd_1x2": (dict(mcs=16, channel="EVA", n_rx=2, est_mode="dd",
                    n_harq_rounds=4), 7.0),
    "interp_awgn": (dict(mcs=16, channel="AWGN", n_harq_rounds=2), 7.0),
    "time_domain_etu": (dict(mcs=10, channel="ETU", time_domain_channel=True,
                             n_harq_rounds=2), 8.0),
    "intra_doppler_eva": (dict(mcs=10, channel="EVA", intra_doppler_hz=200.0,
                               n_harq_rounds=2), 8.0),
    "harq_doppler": (dict(mcs=10, channel="EVA", harq_doppler_hz=10.0,
                          est_mode="joint", n_harq_rounds=2), 8.0),
    "perfect_ce_1x2": (dict(mcs=16, channel="EVA", n_rx=2, perfect_ce=True,
                            n_harq_rounds=2), 4.0),
}


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def replay(jsim, keys):
    """The reference's draws for `keys` from the splits of its _tx_encode:
    TB bits, and per round r the channel normals (split 2 + 2r) shaped as
    the round's draw takes them, and the noise normals (split 3 + 2r)."""
    cfg, cm = jsim.cfg, jsim.chan
    R, A, S = cfg.n_harq_rounds, cfg.n_rx, jsim.fp.samples_per_tti
    sp = jax.vmap(lambda k: jax.random.split(k, 2 + 2 * R))(keys)
    tb = jax.vmap(lambda k: jax.random.bernoulli(
        k, 0.5, (jsim.dlsch.cfg.tbs,)))(sp[:, 0]).astype(jnp.int32)
    taps, noise = [], []
    for r in range(R):
        kc, kn = sp[:, 2 + 2 * r], sp[:, 3 + 2 * r]
        if cfg.channel == "AWGN":
            taps.append(None)
        elif cfg.intra_doppler_hz > 0:
            taps.append(_t(jax.vmap(lambda k: jax.random.normal(
                k, (jsim.fp.symbols_per_subframe, cm.n_taps, 2)))(kc)))
        else:
            n = _t(jax.vmap(lambda k: jax.random.normal(
                k, (cm.n_rx, cm.n_tx, cm.n_taps, 2)))(kc))
            if cm.ricean[2]:
                n = (n, _t(jax.vmap(lambda k: jax.random.normal(
                    k, (1,)))(kc)[:, 0]))
            taps.append(n)
        noise.append(_t(jax.vmap(lambda k: jax.random.normal(
            k, (A, S, 2)))(kn)))
    return _t(tb), taps, noise


def run_reference(jsim, keys, n0, W, ev):
    """Every round of the reference on `keys`: per round (ok, w_soft,
    dci_ok) as numpy."""
    d, kc, kn = jsim._tx(keys)
    out, w_soft, taps = [], None, None
    for r in range(jsim.cfg.n_harq_rounds):
        args = (d, kc[r], kn[r], n0, W, ev)
        if r:
            args += (w_soft, taps)
        ok, w_soft, taps, dci_ok = jsim._round(r)(*args)
        out.append((np.asarray(ok), [np.asarray(w) for w in w_soft],
                    np.asarray(dci_ok)))
    return out


def errs_reach(oks):
    """The reference _step's per-round accounting from the rounds' flags."""
    reached = np.ones_like(oks[0])
    ok_any = np.zeros_like(oks[0])
    errs, reach = [], []
    for ok in oks:
        ok_any = ok_any | ok
        err = reached & ~ok_any
        errs.append(int(err.sum()))
        reach.append(int(reached.sum()))
        reached = err
    return errs, reach


@pytest.fixture(scope="module", params=sorted(MODES))
def pair(request):
    cfg, snr_mid = MODES[request.param]
    cfg = {**COMMON, **cfg}
    return (request.param, snr_mid, JSim(JConfig(**cfg)),
            DlsimFading(DlsimFadingConfig(**cfg, decoder_window=96),
                        device="cpu"))


def run_both(jsim, sim, snr_db, seed):
    n0 = np.float32(10.0 ** (-snr_db / 10.0))
    Wj, evj = jsim.wiener(snr_db), jsim.err_var(snr_db)
    keys = jnp.asarray(host_keys(seed, B))
    want = run_reference(jsim, keys, jnp.float32(n0), Wj, evj)
    Wj = tuple(np.asarray(w) for w in Wj) if isinstance(Wj, tuple) \
        else np.asarray(Wj)
    W, ev = estimator_state_from_reference(Wj, np.asarray(evj), "cpu")
    got = sim.trial(*replay(jsim, keys), float(n0), W, ev)
    return want, got


def check_flags(want, got):
    assert len(got.rounds) == len(want)
    for r, ((jok, _, jdci), res) in enumerate(zip(want, got.rounds)):
        np.testing.assert_array_equal(res.ok.numpy(), jok, err_msg=f"r{r}")
        np.testing.assert_array_equal(res.dci_ok.numpy(), jdci,
                                      err_msg=f"r{r}")
    errs, reach = errs_reach([w[0] for w in want])
    assert got.errs.tolist() == errs and got.reach.tolist() == reach


def test_flags_and_round_counts_equal_reference_at_high_snr(pair):
    _, _, jsim, sim = pair
    want, got = run_both(jsim, sim, 30.0, seed=0)
    check_flags(want, got)
    assert all(w[0].all() and w[2].all() for w in want)
    assert int(got.rounds[0].bit_errs.sum()) == 0
    assert got.reach.tolist() == [B] + [0] * (len(want) - 1)


def test_harq_rounds_match_reference_at_moderate_snr(pair):
    mode, snr, jsim, sim = pair
    want, got = run_both(jsim, sim, snr, seed=1)
    check_flags(want, got)
    assert got.reach[0] == B and got.errs[0] > 0, got.errs   # HARQ exercised
    if mode == "dd_1x2":
        return
    for r, ((_, jw, _), res) in enumerate(zip(want, got.rounds)):
        assert len(res.w_soft) == len(jw)
        for g, w in zip(res.w_soft, jw):
            err = np.abs(g.numpy() - w).max()
            assert err <= 1e-3 * np.abs(w).max(), (r, err, np.abs(w).max())


def test_dd_with_intra_subframe_doppler_raises():
    """The reference does not guard this pair (its round would hand the dd
    estimator pair to the interp estimator); the port refuses it."""
    with pytest.raises(ValueError):
        DlsimFading(DlsimFadingConfig(est_mode="dd", intra_doppler_hz=70.0,
                                      **COMMON), device="cpu")


def test_reference_defaults_run():
    """DlsimFadingConfig() as the reference defines it (interp, 4 HARQ
    rounds, adaptive prior), at batch 2 and 6 PRB with 3 PDCCH symbols."""
    sim = DlsimFading(DlsimFadingConfig(n_rb=6, n_pdcch_symbols=3, batch=2,
                                        n_turbo_iter=2), device="cpu")
    errs, reach = sim.run_snr(20.0, 2)
    assert reach[0] == 2 and len(errs) == 4 and sim.dci_miss == 0


@pytest.mark.parametrize("mcs,snr", [(4, 1.0), (16, 12.0)])
def test_awgn_trial_matches_reference(mcs, snr):
    """DlsimAwgn.trial against the reference's _trial_step on its own draws
    (split 0: TB bits, split 1: noise normals): the same flags, and the
    same bit errors."""
    cfg = dict(mcs=mcs, n_rb=25, batch=B, n_turbo_iter=4)
    jsim, sim = JAwgn(JAwgnConfig(**cfg)), DlsimAwgn(
        DlsimConfig(**cfg, decoder_window=96), device="cpu")
    keys = jnp.asarray(host_keys(3, B))
    n0 = np.float32(10.0 ** (-snr / 10.0))
    jok, jerrs = (np.asarray(x) for x in jsim._trial_step(keys,
                                                          jnp.float32(n0)))
    sp = jax.vmap(jax.random.split)(keys)
    tb = jax.vmap(lambda k: jax.random.bernoulli(
        k, 0.5, (jsim.dlsch.cfg.tbs,)))(sp[:, 0]).astype(jnp.int32)
    noise = jax.vmap(lambda k: jax.random.normal(
        k, (jsim.fp.samples_per_tti, 2)))(sp[:, 1])
    res = sim.trial(_t(tb), _t(noise), float(n0))
    np.testing.assert_array_equal(res.ok.numpy(), jok)
    np.testing.assert_array_equal(res.bit_errs.numpy(), jerrs)
    assert jok.any()


@pytest.mark.parametrize("est_mode", ["interp", "joint", "dd"])
@pytest.mark.parametrize("est_prior", ["exp", "pdp"])
def test_estimator_state_equals_reference(est_mode, est_prior):
    """wiener and err_var of each receiver, with the generic and the
    matched-PDP delay prior, built from the port's numpy plans, equal the
    reference's carried over by convert.py (the interp stack, the joint
    matrix, the dd pair; the joint or dd posterior)."""
    cfg = dict(mcs=10, n_rb=25, channel="EVA", n_rx=2, delay_scale=0.651,
               est_mode=est_mode, est_prior=est_prior)
    jsim = JSim(JConfig(**cfg))
    sim = DlsimFading(DlsimFadingConfig(**cfg), device="cpu")
    Wj = jsim.wiener(12.0)
    Wj = tuple(np.asarray(w) for w in Wj) if isinstance(Wj, tuple) \
        else np.asarray(Wj)
    want_W, want_ev = estimator_state_from_reference(
        Wj, np.asarray(jsim.err_var(12.0)), "cpu")
    got_W, got_ev = sim.wiener(12.0), sim.err_var(12.0)
    if est_mode == "dd":
        assert isinstance(got_W, tuple) and len(got_W) == 2
    for g, w in zip(got_W if est_mode == "dd" else [got_W],
                    want_W if est_mode == "dd" else [want_W]):
        assert g.dtype == torch.complex64 and g.shape == w.shape
        assert torch.equal(g, w)
    assert torch.equal(got_ev, want_ev)
    assert bool((got_ev > 0).all()) == (est_mode != "interp")
