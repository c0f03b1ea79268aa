"""The closed loops over the per-TTI procedures: UlGrantSim (the format-0
grant over the DL, the granted PUSCH with rv-cycling HARQ) and
TddFrameSim (whole TDD frames), PyTorch port against the JAX package on
the same draws.

UlGrantSim.trial takes the reference's per-trial split(key, 3 + 2R)
draws: [0] the DL noise, [1] the TB bits, [3 + 2r] round r's UL noise;
DCI errors and per-round errors and reach must equal the reference's
`_trial_step`. TddFrameSim.run_frame draws its TBs from numpy's
default_rng(seed) as the reference does and takes the reference's
per-subframe noise (host_keys(seed, B, stream=sf)) injected: the counts,
the activity log, the DAI outcomes and the bundled ACKs must be equal,
the UpPTS SRS SNR within 1e-5 of its scale. 6 and 25 PRB, batch 4,
decoder window 96 on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.phy.channel_est import make_wiener_stack
from openair4g_tpu.phy.pusch import make_ul_wiener
from openair4g_tpu.sim.tddsim import TddFrameSim as JTdd
from openair4g_tpu.sim.tddsim import TddsimConfig as JTddConfig
from openair4g_tpu.sim.ulgrantsim import UlGrantConfig as JGrantConfig
from openair4g_tpu.sim.ulgrantsim import UlGrantSim as JGrant
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.sim.tddsim import (TddFrameSim, TddsimConfig,
                                            valid_pusch_rb)
from openair4g_tpu_torch.sim.ulgrantsim import UlGrantConfig, UlGrantSim

torch.set_num_threads(1)

B = 4


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------- UlGrantSim --

def replay_grant(jsim, keys):
    R = jsim.cfg.n_harq_rounds
    S = jsim.fp.samples_per_tti
    sp = jax.vmap(lambda k: jax.random.split(k, 3 + 2 * R))(keys)

    def normals(col):
        return _t(jax.vmap(lambda k: jax.random.normal(k, (S, 2)))(col))
    tb = jax.vmap(lambda k: jax.random.bernoulli(
        k, 0.5, (jsim.codec.cfg.tbs,)))(sp[:, 1]).astype(jnp.int32)
    return (normals(sp[:, 0]), _t(tb),
            [normals(sp[:, 3 + 2 * r]) for r in range(R)])


# (config, [(DL SNR, UL SNR, seed, expected DCI errors or None)])
GRANT_CASES = {
    "1 round": (dict(mcs_ul=6, rb_offset=2, n_prb=12, n_harq_rounds=1),
                [(20.0, 20.0, 0, 0), (-30.0, 20.0, 1, B)]),
    "2 rounds": (dict(mcs_ul=10, rb_offset=0, n_prb=20, n_harq_rounds=2),
                 [(20.0, 0.0, 2, 0), (-7.0, 10.0, 3, None)]),
}


@pytest.mark.parametrize("case", sorted(GRANT_CASES))
def test_ulgrant_trial_equals_reference(case):
    cfg, points = GRANT_CASES[case]
    cfg = dict(n_rb=25, batch=B, n_turbo_iter=4, **cfg)
    jsim = JGrant(JGrantConfig(**cfg))
    sim = UlGrantSim(UlGrantConfig(**cfg, decoder_window=96), device="cpu")
    np.testing.assert_array_equal(sim.grant_payload, jsim.grant_payload)
    assert sim.ue_tx.cfg.n_rb_alloc == jsim.ue_tx.cfg.n_rb_alloc
    for snr_dl, snr_ul, seed, dci_want in points:
        n0_dl = np.float32(10.0 ** (-snr_dl / 10.0))
        n0_ul = np.float32(10.0 ** (-snr_ul / 10.0))
        wj = (jnp.asarray(make_wiener_stack(jsim.gm, float(n0_dl) / 4.0)),
              jnp.asarray(make_ul_wiener(jsim.enb_rx.pm, float(n0_ul))))
        keys = jnp.asarray(host_keys(seed, B))
        want = [np.asarray(x) for x in jsim._step(
            keys, jnp.float32(n0_dl), jnp.float32(n0_ul), *wj)]
        res = sim.trial(*replay_grant(jsim, keys), n0_dl, n0_ul,
                        sim.wiener(snr_dl, snr_ul))
        got = [res.dci_errs.numpy(), res.errs.numpy(), res.reach.numpy()]
        for g, w, name in zip(got, want, ("dci_errs", "errs", "reach")):
            np.testing.assert_array_equal(g, w, err_msg=f"{case} {name}")
        if dci_want is not None:
            assert int(res.dci_errs) == dci_want
        if snr_dl < -20:            # DTX: the UE stays silent
            assert int(res.errs[0]) == B
        if snr_ul < 5:
            # the marginal UL point: round 0 fails for some, HARQ recovers
            assert 0 < int(res.errs[0]) and int(res.errs[-1]) < int(
                res.errs[0]), res.errs


# ----------------------------------------------------------- TddFrameSim --

def tdd_noise(jsim, seed):
    """The reference frame's per-subframe noise normals [10, B, S, 2]."""
    S = jsim._ul_pair(2)[0].fp.samples_per_tti
    return torch.stack([_t(jax.vmap(lambda k: jax.random.normal(
        k, (S, 2)))(jnp.asarray(host_keys(seed, jsim.cfg.batch, stream=sf))))
        for sf in range(10)])


# (config, [(SNR, seed)]): at 12 dB every TB decodes; at -4 dB some DCIs
# are missed and the DAI check finds them. The 25 PRB frame at the MCS 4
# waterfall takes the reference about 45 s on the CPU (its frame runs
# eagerly): slow.
TDD_CASES = {
    "config 1, 6 PRB": (dict(tdd_config=1), [(12.0, 0), (-4.0, 1)]),
    "config 2, 25 PRB": (dict(tdd_config=2, n_rb=25, n_pdcch=1),
                         [(0.2, 2)]),
}


@pytest.mark.parametrize("case", [
    "config 1, 6 PRB",
    pytest.param("config 2, 25 PRB", marks=pytest.mark.slow)])
def test_tdd_frame_equals_reference(case):
    cfg, points = TDD_CASES[case]
    cfg = dict(batch=B, n_turbo_iter=4, **cfg)
    jsim = JTdd(JTddConfig(**cfg))
    sim = TddFrameSim(TddsimConfig(**cfg, decoder_window=96), device="cpu")
    for snr, seed in points:
        want = jsim.run_frame(snr, seed=seed)
        got = sim.run_frame(snr, seed=seed, noise=tdd_noise(jsim, seed))
        for key in ("dl_ok", "dl_tot", "ul_ok", "ul_tot", "log",
                    "n_dl_assignments", "dl_bler", "ul_bler"):
            assert got[key] == want[key], (case, snr, key)
        for key in ("dai_miss", "ack_bundle"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert abs(got["srs"] - want["srs"]) <= 1e-5 * abs(want["srs"])
        assert [d for _, d, _ in got["log"]] == list(sim.pattern)
        if snr > 10:
            assert got["dl_ok"] == got["dl_tot"] and got["ul_ok"] == \
                got["ul_tot"] and not got["dai_miss"].any()
    if case.startswith("config 1"):
        assert got["dai_miss"].any() and not got["dai_miss"].all()


def test_tdd_valid_pusch_sizes():
    """2^a 3^b 5^c allocations, as the reference's _valid_pusch_rb."""
    for n in range(1, 101):
        assert valid_pusch_rb(n) == JTdd._valid_pusch_rb(n)


def test_tdd_frame_draws_its_own_noise():
    """Without injected noise the frame draws it on its device from the
    seed: the same seed gives the same frame."""
    sim = TddFrameSim(TddsimConfig(batch=2, n_turbo_iter=2), device="cpu")
    a, b = sim.run_frame(12.0, seed=4), sim.run_frame(12.0, seed=4)
    assert a["dl_ok"] == a["dl_tot"] == 8 and a["ul_ok"] == a["ul_tot"] == 8
    assert a["srs"] == b["srs"] and a["log"] == b["log"]


@pytest.mark.parametrize("build", [
    lambda d: UlGrantSim(UlGrantConfig(batch=2), device=d),
    lambda d: TddFrameSim(TddsimConfig(batch=2), device=d)],
    ids=["UlGrantSim", "TddFrameSim"])
def test_closed_loops_run_on_the_card_unless_asked_for_the_cpu(
        monkeypatch, build):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(None)
    assert build("cpu").device == torch.device("cpu")


# ------------------- the reference's Monte-Carlo checks through the port --

def test_ul_grant_loop_through_the_port():
    """tests/test_sched_ul.py's good-SNR and missed-grant points with the
    port's draws: no DCI miss and every TB at 20/20 dB; at -30 dB on the
    DL every trial misses its grant and its TB (DTX)."""
    sim = UlGrantSim(UlGrantConfig(n_rb=25, mcs_ul=6, rb_offset=2, n_prb=12,
                                   n_harq_rounds=1, batch=8, n_turbo_iter=4),
                     device="cpu")
    assert sim.run_snr(20.0, 20.0, 8)[0] == 0
    dci_errs, errs, reach = sim.run_snr(20.0, 20.0, 8)
    assert dci_errs == 0 and errs[0] == 0 and reach[0] == 8
    dci_errs, errs, _ = sim.run_snr(-30.0, 20.0, 8)
    assert dci_errs == 8 and errs[0] == 8


def test_ul_grant_harq_recovers_marginal_snr_through_the_port():
    """tests/test_sched_ul.py's rv-cycling HARQ point with the port's
    draws."""
    sim = UlGrantSim(UlGrantConfig(n_rb=25, mcs_ul=10, rb_offset=0,
                                   n_prb=20, n_harq_rounds=3, batch=16,
                                   n_turbo_iter=5), device="cpu")
    dci_errs, errs, _ = sim.run_snr(20.0, -2.5, 16)
    assert dci_errs == 0
    assert errs[0] > 0 and errs[-1] < errs[0], errs


@pytest.mark.parametrize("cfg,pattern,n_dl,n_ul", [
    (dict(tdd_config=1), "DSUUDDSUUD", 4, 4),
    (dict(tdd_config=2), "DSUDDDSUDD", 6, 2),
    (dict(tdd_config=1, n_rb=25, n_pdcch=2), "DSUUDDSUUD", 4, 4)],
    ids=["config 1", "config 2", "config 1 25 PRB"])
def test_tdd_frames_through_the_port(cfg, pattern, n_dl, n_ul):
    """tests/test_tddsim.py's frames at 12 dB with the port's draws: the
    activity follows the pattern, every TB decodes, the UpPTS SRS SNR
    within 4 dB of 12."""
    out = TddFrameSim(TddsimConfig(batch=2, **cfg),
                      device="cpu").run_frame(12.0)
    assert "".join(d for _, d, _ in out["log"]) == pattern
    assert out["dl_ok"] == out["dl_tot"] == 2 * n_dl
    assert out["ul_ok"] == out["ul_tot"] == 2 * n_ul
    assert abs(out["srs"] - 12.0) < 4.0, out["srs"]


@pytest.mark.slow
def test_tdd_bler_points_through_the_port():
    """tests/test_tddsim.py's low-SNR point and the TDD D subframe on the
    FDD MCS 4 waterfall (within 0.15), with the port's draws: about 15 s
    on one CPU core, slow as the reference's."""
    from openair4g_tpu_torch.sim.dlsim import DlsimFading, DlsimFadingConfig
    sim = TddFrameSim(TddsimConfig(tdd_config=1, batch=8), device="cpu")
    lo, hi = sim.run_frame(-3.0), sim.run_frame(8.0)
    assert lo["dl_bler"] >= hi["dl_bler"] and lo["ul_bler"] >= hi["ul_bler"]
    assert hi["dl_bler"] <= 0.25 and hi["ul_bler"] <= 0.25
    snr = 0.2
    tdd = TddFrameSim(TddsimConfig(tdd_config=1, n_rb=25, n_pdcch=1,
                                   mcs_dl=4, batch=16), device="cpu")
    outs = [tdd.run_frame(snr, seed=seed) for seed in range(4)]
    tdd_bler = 1 - sum(o["dl_ok"] for o in outs) / sum(o["dl_tot"]
                                                       for o in outs)
    fdd = DlsimFading(DlsimFadingConfig(mcs=4, n_rb=25, channel="AWGN",
                                        n_harq_rounds=1, batch=64),
                      device="cpu")
    errs, reach = fdd.run_snr(snr, 256)
    assert abs(tdd_bler - errs[0] / reach[0]) < 0.15, (tdd_bler, errs)
