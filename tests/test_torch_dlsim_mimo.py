"""The multi-antenna simulators as a whole: DlsimTxDiv (TM2) and DlsimSm
(TM3/4/5/6) of the PyTorch port against the JAX simulators' `_step` on the
same draws (TB bits, the TM5 interferer, channel and noise normals),
replayed from the reference's own key splits, with identical Wiener
matrices.

25 PRB (so the SFBC-coded PDCCH is on), batch 4, 4 turbo iterations,
decoder window 96 on both sides, 30 dB. TB flags, DCI flags and bit errors
must be equal; the decoder's input LLRs agree to rtol = atol = 1e-3
(FFT, matmul and complex-division rounding, amplified by 1/n0 at 30 dB).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.phy.channel_est import make_wiener_stack
from openair4g_tpu.sim.dlsim_mimo import DlsimTxDiv as JTxDiv
from openair4g_tpu.sim.dlsim_mimo import DlsimTxDivConfig as JTxDivConfig
from openair4g_tpu.sim.dlsim_sm import DlsimSm as JSm
from openair4g_tpu.sim.dlsim_sm import DlsimSmConfig as JSmConfig
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.convert import wiener_stack_from_reference
from openair4g_tpu_torch.sim.dlsim_mimo import DlsimTxDiv, DlsimTxDivConfig
from openair4g_tpu_torch.sim.dlsim_sm import DlsimSm, DlsimSmConfig

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

B = 4
SNR = 30.0
COMMON = dict(n_rb=25, batch=B, n_turbo_iter=4)
CASES = {
    "tm2": dict(mcs=25, channel="EVA"),
    "tm3": dict(tm=3, mcs=16, mcs2=9),
    "tm4": dict(tm=4, mcs=11, mcs2=11, pmi=2),
    "tm5": dict(tm=5, mcs=12, pmi=0, pmi_interferer=1),
    "tm6": dict(tm=6, mcs=20, pmi=3),
}


def _replay(jsim, keys):
    """The reference's draws for `keys`, from its own key splits."""
    R = jsim.cfg.n_rx
    S = jsim.fp.samples_per_tti
    if isinstance(jsim, JTxDiv):
        sp = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        tb = jax.vmap(lambda k: jax.random.bernoulli(
            k, 0.5, (jsim.dlsch.cfg.tbs,)))(sp[:, 0]).astype(jnp.int32)
        taps = jax.vmap(lambda k: jax.random.normal(
            k, (R, 2, jsim.chan.n_taps, 2)))(sp[:, 1])
        noise = jax.vmap(lambda k: jax.random.normal(k, (R, S, 2)))(sp[:, 2])
        return [tb], taps, noise, None
    sp = jax.vmap(lambda k: jax.random.split(k, 5))(keys)
    tbs = [jax.vmap(lambda k: jax.random.bernoulli(
        k, 0.5, (c.cfg.tbs,)))(jax.vmap(jax.random.fold_in)(
            sp[:, 0], jnp.full(B, q))).astype(jnp.int32)
        for q, c in enumerate(jsim.codecs)]
    interferer = None
    if jsim.cfg.tm == 5:
        interferer = jax.vmap(lambda k: jax.random.randint(
            k, (jsim.gm.n_data_re,), 0, 4))(sp[:, 1])
    h = jax.vmap(lambda k: jax.random.normal(k, (R, 2, 2)))(sp[:, 2])
    noise = jax.vmap(lambda k: jax.random.normal(k, (R, S, 2)))(sp[:, 3])
    return tbs, h, noise, interferer


def _tensor(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    """One JAX compile and one step of each side per configuration."""
    case = CASES[request.param]
    if request.param == "tm2":
        jsim = JTxDiv(JTxDivConfig(**COMMON, **case))
        sim = DlsimTxDiv(DlsimTxDivConfig(**COMMON, **case,
                                          decoder_window=96), device="cpu")
        codecs = [jsim.dlsch]
    else:
        jsim = JSm(JSmConfig(**COMMON, **case))
        sim = DlsimSm(DlsimSmConfig(**COMMON, **case, decoder_window=96),
                      device="cpu")
        codecs = jsim.codecs
    # record the reference decoder's input LLRs from inside its jit
    jllr = {}
    for q, codec in enumerate(codecs):
        def decode(llr, *a, _q=q, _orig=codec.decode, **k):
            jax.debug.callback(lambda x, q=_q: jllr.__setitem__(
                q, np.asarray(x)), llr)
            return _orig(llr, *a, **k)
        codec.decode = decode
    n0 = jnp.float32(10.0 ** (-SNR / 10.0))
    jw = [make_wiener_stack(jsim.gm, float(n0) / 4, port=p) for p in (0, 1)]
    keys = jnp.asarray(host_keys(0, B))
    jok, jerrs, jdci = (np.asarray(x) for x in jsim._step(
        keys, n0, jnp.asarray(jw[0]), jnp.asarray(jw[1])))
    tbs, chan, noise, interferer = _replay(jsim, keys)
    W0, W1 = (wiener_stack_from_reference(w, "cpu") for w in jw)
    if request.param == "tm2":
        res = sim.trial(_tensor(tbs[0]), _tensor(chan), _tensor(noise),
                        float(n0), W0, W1)
    else:
        res = sim.trial([_tensor(t) for t in tbs], _tensor(chan),
                        _tensor(noise), float(n0), W0, W1,
                        _tensor(interferer))
    return dict(jsim=jsim, sim=sim, jok=jok, jerrs=jerrs, jdci=jdci,
                jllr=[jllr[q] for q in range(len(codecs))], res=res)


def test_flags_and_bit_errors_equal_reference(run):
    res = run["res"]
    np.testing.assert_array_equal(res.ok.numpy(), run["jok"])
    np.testing.assert_array_equal(res.dci_ok.numpy(), run["jdci"])
    np.testing.assert_array_equal(res.bit_errs.numpy(), run["jerrs"])
    assert run["jdci"].all()


def test_decoder_input_llrs_match_reference(run):
    res = run["res"]
    assert len(res.llr) == len(run["jllr"])
    for got, want in zip(res.llr, run["jllr"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_sweep_rows_shaped_as_reference(run):
    """run_snr / sweep return what the reference's return (its compiled
    step is reused: one batch of B)."""
    jrows = run["jsim"].sweep([SNR], B, verbose=False)
    rows = run["sim"].sweep([SNR], B, verbose=False)
    assert len(rows) == len(jrows) == 1
    for got, want in zip(rows[0], jrows[0]):
        assert type(got) is type(want)
        assert np.shape(got) == np.shape(want)
    assert int(np.sum(rows[0][2])) == int(np.sum(jrows[0][2])) == B
    assert run["sim"].dci_miss == 0


@pytest.mark.parametrize("change", [dict(channel="Rice1"),
                                    dict(channel="SCM_C"),
                                    dict(channel="Rayleigh1_corr")])
def test_txdiv_runs_ricean_scm_and_correlated_channels(change):
    """The 2x2 Ricean (with its random-AoA draw), SCM and correlated models
    (their tap draws are held to the reference in test_torch_channels.py),
    perfect channel knowledge at 6 PRB: every TB decodes at 30 dB."""
    sim = DlsimTxDiv(DlsimTxDivConfig(**{**COMMON, "n_rb": 6, "mcs": 4,
                                         "perfect_ce": True, **change}),
                     device="cpu")
    errs, trials = sim.run_snr(SNR, B)
    assert errs == 0 and trials == B, (errs, trials)


def test_sm_refuses_other_transmission_modes_and_misplaced_interferer():
    with pytest.raises(ValueError):
        DlsimSm(DlsimSmConfig(tm=7, **COMMON), device="cpu")
    sim = DlsimSm(DlsimSmConfig(tm=6, mcs=4, **COMMON), device="cpu")
    W0, W1 = sim.wiener(SNR)
    tb = [torch.zeros(B, sim.codecs[0].cfg.tbs, dtype=torch.int32)]
    h = torch.zeros(B, 2, 2, 2)
    noise = torch.zeros(B, 2, sim.fp.samples_per_tti, 2)
    with pytest.raises(ValueError):
        sim.trial(tb, h, noise, 1e-3, W0, W1,
                  interferer=torch.zeros(B, sim.gm.n_data_re,
                                         dtype=torch.long))


# ---------------------------------------------------------------------------
# Perfect channel knowledge at 6 PRB (no CCE at CFI 1, so no PDCCH): the
# reference's own link sanity checks (tests/test_mimo.py,
# tests/test_mimo_sm.py), run through the port's run_snr on the CPU.

def test_txdiv_perfect_ce_waterfall():
    sim = DlsimTxDiv(DlsimTxDivConfig(mcs=4, n_rb=6, n_rx=2, batch=32,
                                      n_turbo_iter=6, perfect_ce=True),
                     device="cpu")
    assert not sim.pdcch.on
    e_lo, t = sim.run_snr(-6.0, 32)
    e_hi, _ = sim.run_snr(4.0, 32)
    assert e_lo / t >= 0.4 and e_hi / t <= 0.1, (e_lo, e_hi, t)


@pytest.mark.parametrize("tm,pmi,snr", [(3, 1, 30.0), (6, 2, 25.0)])
def test_sm_perfect_ce_high_snr_decodes(tm, pmi, snr):
    sim = DlsimSm(DlsimSmConfig(tm=tm, mcs=6, n_rb=6, pmi=pmi, batch=16,
                                n_turbo_iter=6, perfect_ce=True),
                  device="cpu")
    errs, trials = sim.run_snr(snr, 16)
    assert errs.sum() == 0 and trials == 16, (errs, trials)
    assert sim.dci_miss == 0


def test_tm5_interference_aware_beats_naive():
    common = dict(tm=5, mcs=4, n_rb=6, pmi=0, pmi_interferer=1, batch=32,
                  n_turbo_iter=6, perfect_ce=True)
    e_ia, t = DlsimSm(DlsimSmConfig(ia_receiver=True, **common),
                      device="cpu").run_snr(20.0, 64)
    e_nv, _ = DlsimSm(DlsimSmConfig(ia_receiver=False, **common),
                      device="cpu").run_snr(20.0, 64)
    assert e_ia.sum() <= e_nv.sum() and e_ia.sum() <= 0.25 * t, (e_ia, e_nv)
