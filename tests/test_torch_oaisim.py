"""The system emulator of the PyTorch port (sim/oaisim.py, sim/abstraction.py)
against the JAX package on the same draws.

Oaisim.run_frames takes each downlink TTI's draws injected; here they are
the reference's own, replayed from its per-TTI keys host_keys(seed + 1,
U * E, stream=frame * 10 + tti) split in two (abstraction: [0] the links'
tap normals, [1] of link 0 the one coin-flip uniform vector) or three
(full PHY: [0] the tap normals, [1] of the first E links the eNBs' fresh
TB bits, [2] of the first U links the UEs' noise normals). The host numpy
generator is seeded alike on both sides and consumed in the same order.
Every per-TTI error flag, every stats array, the serving cells, the
handover events, summary() and the pcap bytes must be equal. 6 PRB (25
where the reference test takes the default). The full-PHY mode's parity
is in test_torch_oaisim_phy.py.

Coin flips at their threshold: `u < bler` in float32 flips when u lies
within rounding of the BLER, and one flipped flag moves HARQ state and the
later host draws. So each abstraction run asserts that every scheduled
UE's uniform lies more than 1e-5 from its BLER (none is skipped); the
seeds below pass that check as the reference tests give them."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.sim import abstraction as jab
from openair4g_tpu.sim.oaisim import Oaisim as JOaisim
from openair4g_tpu.sim.oaisim import OaisimConfig as JConfig
from openair4g_tpu.sim.oaisim import default_bler_table as j_default_table
from openair4g_tpu.utils.log import set_comp_log as j_set_comp_log
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.sim import abstraction as ab
from openair4g_tpu_torch.sim.oaisim import (Oaisim, OaisimConfig, TtiDraws,
                                            calibrated_bler_table,
                                            default_bler_table, run_scenario)
from openair4g_tpu_torch.utils.log import set_comp_log
from openair4g_tpu_torch.utils.opt import KIND_MAC, read_pcap

torch.set_num_threads(1)

# Flip margin: a scheduled UE's uniform must lie further than this from
# its BLER, so that float32 rounding cannot decide the coin flip.
FLIP_MARGIN = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _draw_program(n: int, U: int, E: int, n_taps: int, tbs: int,
                  grid: tuple):
    """The reference's per-TTI draws from its keys, jitted once a shape."""
    def draws(keys):
        ev = jax.vmap(lambda k: jax.random.split(k, n))(keys)
        normals = jax.vmap(lambda k: jax.random.normal(
            k, (1, 1, n_taps, 2)))(ev[:, 0])
        if n == 2:
            return normals, jax.random.uniform(ev[:, 1][0], (U,))
        tb = jax.vmap(lambda k: jax.random.bernoulli(
            k, 0.5, (tbs,)))(ev[:E, 1]).astype(jnp.int32)
        noise = jax.vmap(lambda k: jax.random.normal(
            k, grid + (2,)))(ev[:U, 2])
        return normals, tb, noise
    return jax.jit(draws)


def replay(jsim, abs_tti: int) -> TtiDraws:
    """The reference's draws of downlink TTI abs_tti (run_frames :616)."""
    cfg, cm, fp = jsim.cfg, jsim.chan, jsim.fp
    U, E = cfg.n_ue, cfg.n_enb
    keys = jnp.asarray(host_keys(cfg.seed + 1, U * E, stream=abs_tti))
    n = 2 if cfg.mode == "abstraction" else 3
    out = [_t(x) for x in _draw_program(
        n, U, E, cm.n_taps, jsim.tbs,
        (fp.symbols_per_subframe, fp.n_fft))(keys)]
    normals = None if cm.name == "AWGN" else out[0]
    if n == 2:
        return TtiDraws(normals, uniforms=out[1])
    return TtiDraws(normals, tb_bits=out[1], noise=out[2])


def record_flags(sim) -> list:
    """Each downlink TTI's (abs TTI, sched, err) as _trace_tti sees them."""
    out = []
    orig = sim._trace_tti

    def hook(tti, sched, err, tb=None):
        out.append((sim._frame * 10 + tti, np.array(sched), np.array(err)))
        return orig(tti, sched, err, tb)
    sim._trace_tti = hook
    return out


def guard_flips(jsim) -> list:
    """Wrap the reference's abstraction TTI: for each, the least distance
    between a scheduled UE's uniform and its BLER."""
    orig = jsim._tti
    lookup = jax.jit(jsim.table.lookup)
    gaps = []

    def step(taps, keys, p_rx, onehot, sched, acc):
        out = orig(taps, keys, p_rx, onehot, sched, acc)
        bler = np.asarray(lookup(out[2]))
        _, u = _draw_program(2, jsim.cfg.n_ue, jsim.cfg.n_enb,
                             jsim.chan.n_taps, jsim.tbs,
                             (jsim.fp.symbols_per_subframe,
                              jsim.fp.n_fft))(keys)
        s = np.asarray(sched)
        if s.any():
            gaps.append(float(np.abs(np.asarray(u) - bler)[s].min()))
        return out
    jsim._tti = step
    return gaps


def walk_to_handover(sim):
    """tests/test_handover.py's drive: one UE placed in cell 0, then walked
    toward cell 1 a frame a step."""
    sim.ue_xy[0] = [50.0, 0.0]
    sim._update_links()
    sim.serving_rrc[:] = np.argmax(sim.p_rx, axis=1)
    sim._update_links()
    for x in (50, 150, 250, 330, 420, 480, 480, 480):
        sim.ue_xy[0] = [float(x), 0.0]
        sim._update_links()
        yield x


# name: (config, frames, drive); the configurations of tests/test_oaisim.py,
# test_observability.py's oaisim tests, test_tddsim.py, test_ul_mac.py and
# test_handover.py
SCENARIO = {"topology": {"n_enb": 2, "n_ue": 6, "cell_spacing_m": 400.0,
                         "ue_speed_mps": 0.0},
            "channel": {"n_rb": 6, "mcs": 4, "model": "EPA",
                        "tx_power_db": 45.0},
            "application": {"traffic": "full"},
            "emulation": {"mode": "abstraction", "mac": "pf",
                          "n_harq_rounds": 4, "n_frames": 5, "seed": 3}}
ABS = {
    "geometry": (dict(n_enb=2, n_ue=16, n_rb=6, mcs=4, tx_power_db=40.0,
                      speed_mps=0.0, seed=3), 20),
    "high power": (dict(n_enb=1, n_ue=4, n_rb=6, mcs=0, tx_power_db=60.0,
                        speed_mps=0.0, seed=1), 10),
    "full buffer": (dict(n_enb=1, n_ue=4, n_rb=6, traffic="full", seed=2), 5),
    "on-off": (dict(n_enb=1, n_ue=4, n_rb=6, traffic="onoff", onoff_p=0.3,
                    seed=2), 5),
    "PF MAC": (dict(n_enb=1, n_ue=6, n_rb=6, mcs=4, tx_power_db=45.0,
                    mac="pf", speed_mps=0.0, seed=9), 10),
    "HARQ 1 round": (dict(n_enb=1, n_ue=8, n_rb=6, mcs=10, tx_power_db=24.0,
                          speed_mps=0.0, seed=11, n_harq_rounds=1), 30),
    "HARQ 4 rounds": (dict(n_enb=1, n_ue=8, n_rb=6, mcs=10,
                           tx_power_db=24.0, speed_mps=0.0, seed=11,
                           n_harq_rounds=4), 30),
    "scenario": (dataclasses.asdict(JConfig.from_scenario(SCENARIO)), 5),
    "rwp, cbr": (dict(n_enb=2, n_ue=4, mobility="rwp", speed_mps=30.0,
                      traffic="cbr", seed=3), 10),
    "static, poisson": (dict(n_enb=1, n_ue=2, mobility="static",
                             traffic="poisson", seed=3), 5),
    "EESM": (dict(n_enb=1, n_ue=3, esm="eesm", seed=2), 5),
    "MIESM": (dict(n_enb=1, n_ue=3, esm="miesm", seed=2), 5),
    "pcap and logs": (dict(n_enb=1, n_ue=2, seed=0), 2),
    "TDD, UL": (dict(n_enb=1, n_ue=2, duplex="tdd", tdd_config=1,
                     ul_traffic=True, ul_arrival_p=1.0, seed=1), 4),
    "UL, HARQ 2, on-off": (dict(n_enb=2, n_ue=6, ul_traffic=True,
                                n_harq_rounds=2, traffic="onoff", seed=1),
                           30),
    "handover": (dict(n_enb=2, n_ue=1, mobility="static", handover=True,
                      a3_ttt_frames=1, cell_spacing=500.0, seed=3), None),
}


def _run_both(cfg: dict, frames, tmp_path, phy: bool = False):
    """The reference and the port from one configuration, each with a
    pcap; returns (jsim, sim, jflags, flags, jout, out, gaps)."""
    port_cfg = dict(cfg, decoder_window=96) if phy else cfg
    jsim = JOaisim(JConfig(**cfg), pcap_path=str(tmp_path / "j.pcap"))
    sim = Oaisim(OaisimConfig(**port_cfg), pcap_path=str(tmp_path / "p.pcap"),
                 device="cpu")
    jflags, flags = record_flags(jsim), record_flags(sim)
    gaps = None if phy else guard_flips(jsim)
    if frames is None:                  # the handover walk
        for _ in walk_to_handover(jsim):
            jout = jsim.run_frames(1)
        for _ in walk_to_handover(sim):
            out = sim.run_frames(1, draws=lambda t: replay(jsim, t))
    else:
        jout = jsim.run_frames(frames)
        out = sim.run_frames(frames, draws=lambda t: replay(jsim, t))
    jsim.pcap.close()
    sim.pcap.close()
    return jsim, sim, jflags, flags, jout, out, gaps


def _assert_equal_runs(jsim, sim, jflags, flags, jout, out, tmp_path):
    assert len(flags) == len(jflags) > 0
    for (jt, js, je), (t, s, e) in zip(jflags, flags):
        assert t == jt
        np.testing.assert_array_equal(s, js, err_msg=f"sched, TTI {t}")
        np.testing.assert_array_equal(e, je, err_msg=f"flags, TTI {t}")
    assert sorted(sim.stats) == sorted(jsim.stats)
    for k in jsim.stats:
        np.testing.assert_array_equal(sim.stats[k], jsim.stats[k],
                                      err_msg=k)
    assert sorted(out) == sorted(jout)
    for k in jout:
        np.testing.assert_array_equal(out[k], jout[k], err_msg=k)
    np.testing.assert_array_equal(sim.serving, jsim.serving)
    np.testing.assert_array_equal(sim.ue_xy, jsim.ue_xy)
    assert (tmp_path / "p.pcap").read_bytes() == \
        (tmp_path / "j.pcap").read_bytes()


@pytest.mark.parametrize("case", list(ABS))
def test_abstraction_equals_reference(case, tmp_path):
    cfg, frames = ABS[case]
    runs = _run_both(cfg, frames, tmp_path)
    jsim, sim, jflags, flags, jout, out, gaps = runs
    assert min(gaps) > FLIP_MARGIN, f"a coin flip within rounding: {gaps}"
    _assert_equal_runs(*runs[:6], tmp_path)
    np.testing.assert_allclose(sim.acc_eff, jsim.acc_eff, rtol=1e-5)
    if cfg.get("handover"):
        assert out["ho_events"] and out["ho_events"] == jout["ho_events"]
    if case == "HARQ 4 rounds":
        assert out["retx_total"] > 0
    if case == "TDD, UL":
        assert sim.stats["tti_skipped_dl"] == 4 * 6
        assert (out["ul_tb_ok"] > 0).any()


def test_scenario_config_equals_reference():
    want = dataclasses.asdict(JConfig.from_scenario(SCENARIO))
    assert dataclasses.asdict(OaisimConfig.from_scenario(SCENARIO)) == \
        dict(want, decoder_window=None)


def test_run_scenario_from_a_dict_and_a_file(tmp_path):
    """test_oaisim.py::test_scenario_config_runs on the port, on the CPU:
    the scenario's own frame count, or the caller's."""
    assert run_scenario(SCENARIO, device="cpu")["frames"] == 5
    path = tmp_path / "scenario.json"
    path.write_text(json.dumps(SCENARIO))
    assert run_scenario(str(path), n_frames=2, device="cpu")["frames"] == 2


def test_pcap_records_and_mac_log_lines(tmp_path, capsys):
    """test_observability.py::test_oaisim_pcap_and_logs on the port: one
    MAC record a TTI, and the port's MAC debug lines, which the
    reference's logger level does not govern."""
    set_comp_log("MAC", "debug")
    j_set_comp_log("MAC", "warn")
    try:
        path = str(tmp_path / "oaisim.pcap")
        sim = Oaisim(OaisimConfig(n_enb=1, n_ue=2, seed=0), pcap_path=path,
                     device="cpu")
        sim.run_frames(2)
        sim.pcap.close()
        recs = read_pcap(path)
        assert len(recs) == 20
        assert all(k == KIND_MAC for _, k, _, _, _ in recs)
        assert "[MAC][D] tti=" in capsys.readouterr().out
    finally:
        set_comp_log("MAC", "warn")


def test_run_frames_draws_on_its_device():
    """Without injected draws the sim draws from its own generator: the
    same seed gives the same run, another seed another fade."""
    cfg = dict(n_enb=2, n_ue=8, n_rb=6, mcs=10, tx_power_db=24.0,
               speed_mps=0.0, n_harq_rounds=2)
    a = Oaisim(OaisimConfig(**cfg, seed=4), device="cpu").run_frames(3)
    b = Oaisim(OaisimConfig(**cfg, seed=4), device="cpu").run_frames(3)
    np.testing.assert_array_equal(a["per_ue_bler"], b["per_ue_bler"])
    assert a["retx_total"] == b["retx_total"] > 0
    sim = Oaisim(OaisimConfig(**cfg, seed=4), device="cpu")
    d = sim.draw()
    assert d.uniforms.shape == (8,)
    assert d.tap_normals.shape == (16, 1, 1, sim.chan.n_taps, 2)


# ------------------------------------------------------------ abstraction --

def _sinrs(shape=(64, 25), seed=0):
    rng = np.random.default_rng(seed)
    return (10 ** rng.uniform(-3, 4, shape)).astype(np.float32)


@pytest.mark.parametrize("beta", [0.6, 1.6, 5.0, 18.0, 40.0])
def test_eesm_equals_reference(beta):
    """Within 1e-6 relative, plus beta * 2 float32 eps: -beta ln(s) of a
    mean s that XLA and torch sum in different orders, a few float32 ulps
    apart."""
    s = _sinrs()
    want = np.asarray(jab.eesm(jnp.asarray(s), beta))
    got = ab.eesm(torch.from_numpy(s), beta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=beta * 2 * np.finfo(np.float32).eps)


@pytest.mark.parametrize("Qm", [2, 4, 6])
def test_miesm_equals_reference(Qm):
    s = _sinrs(seed=Qm)
    want = np.asarray(jab.miesm(jnp.asarray(s), Qm))
    got = ab.miesm(torch.from_numpy(s), Qm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_miesm_keeps_jnp_interp_tie_rule():
    """The saturated QPSK MI curve has 28 equal values at its top (16QAM
    14, 64QAM 2). At MI 2.0 jnp.interp takes the last zero-width segment's
    left value, 29.5 dB, where np.interp gives 30.0: miesm of a saturated
    link is 891.25, not 1,000."""
    g_db, g_mi = ab._mi_grid(2)
    assert [int((np.diff(ab._mi_grid(q)[1]) == 0).sum())
            for q in (2, 4, 6)] == [28, 14, 2]
    top = torch.tensor([float(np.float32(g_mi[-1]))])
    got = ab.interp(top, *(torch.tensor(a, dtype=torch.float32)
                           for a in (g_mi, g_db)))
    assert float(got[0]) == 29.5
    assert np.interp(g_mi[-1], g_mi, g_db) == 30.0
    sat = np.full((2, 6), 1e6, np.float32)
    got = ab.miesm(torch.from_numpy(sat), 2).numpy()
    want = np.asarray(jab.miesm(jnp.asarray(sat), 2))
    np.testing.assert_allclose(got, 10 ** 2.95, rtol=1e-6)     # 891.25
    np.testing.assert_array_equal(got, want)


def test_interp_equals_jnp_interp_bit_for_bit():
    """The same float32 operations in the same order, ties, the ends and
    left=/right= included, on inputs that hit grid points exactly."""
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(-5, 5, 40)).astype(np.float32)
    xp[10:14] = xp[10]                  # a run of equal grid points
    fp = rng.normal(size=40).astype(np.float32)
    x = np.concatenate([rng.uniform(-7, 7, 2000).astype(np.float32), xp])
    for left, right in ((None, None), (0.0, float(fp[-1]) - 1.0)):
        want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                     jnp.asarray(fp), left=left, right=right))
        got = ab.interp(torch.from_numpy(x), torch.from_numpy(xp),
                        torch.from_numpy(fp), left=left, right=right).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mcs", [0, 4, 10, 16, 25])
def test_bler_lookup_equals_reference(mcs):
    """BlerTable.lookup: within 1e-6 relative, plus what one float32 ulp
    of difference in 10 log10(sinr) (XLA's log and torch's round their
    last bit apart) becomes through the table's slope; the numpy
    attributes equal."""
    jt, t = j_default_table(mcs), default_bler_table(mcs)
    np.testing.assert_array_equal(t.snr_db, jt.snr_db)
    np.testing.assert_array_equal(t.log_bler, jt.log_bler)
    x = (10 ** np.random.default_rng(mcs).uniform(-1, 2.5, 4000)).astype(
        np.float32)
    want = np.asarray(jt.lookup(jnp.asarray(x)))
    got = t.lookup(torch.from_numpy(x)).numpy()
    sdb = 10 * np.log10(x.astype(np.float64))
    slope = np.abs(np.diff(t.log_bler) / np.diff(t.snr_db)).max()
    ulp = np.spacing(np.abs(sdb).astype(np.float32)).astype(np.float64)
    bound = 1e-6 + 2 * slope * ulp
    assert (np.abs(got - want) / want <= bound).all()


def test_draw_block_errors_injected_or_drawn():
    bler = torch.full((4000,), 0.3)
    u = torch.rand(4000, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(ab.draw_block_errors(u, bler).numpy(),
                                  (u < bler).numpy())
    errs = ab.draw_block_errors(torch.Generator().manual_seed(1),
                                bler).float().mean()
    assert abs(float(errs) - 0.3) < 0.03


@pytest.mark.slow
def test_calibrate_eesm_beta_machinery():
    """test_measurements_abstraction.py's calibration call on the port, on
    the CPU. At that call (MCS 4, EVA, 6 PRB, 64 frames) the AWGN table
    that calibrated_bler_table makes is flat in both packages: its window,
    centred on the anchor knee (0.2 dB), lies above this framework's own
    AWGN waterfall, so each of its 9 points sees no error and is clipped
    to 1e-6; the errs are then nearly equal over the candidates (the
    reference's beat each other by 2 % on its draws). So: a finite beta
    from the candidates it returns, and the measured BLERs; then, on the
    anchor curve (not flat) as the AWGN table, a prediction that tracks
    the measured fading BLER better than the worst candidate."""
    table = calibrated_bler_table(4, n_rb=6, n_frames=64, device="cpu")
    np.testing.assert_array_equal(table.log_bler, np.full(9, np.log(1e-6)))
    out = ab.calibrate_eesm_beta(4, channel="EVA", n_rb=6, n_frames=64,
                                 n_realizations=512, device="cpu")
    assert out["beta"] > 0 and out["beta"] in out["betas"]
    assert len(out["errs"]) == len(out["betas"])
    assert np.isfinite(out["errs"]).all()
    assert all(0 <= m <= 1 for m in out["measured"])
    out = ab.calibrate_eesm_beta(4, channel="EVA", n_rb=6, n_frames=64,
                                 n_realizations=512,
                                 awgn_table=default_bler_table(4),
                                 device="cpu")
    assert out["beta"] > 0
    assert min(out["errs"]) < max(out["errs"])
    assert all(0 <= m <= 1 for m in out["measured"])
