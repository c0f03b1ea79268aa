"""The full eNB-TX -> UE-RX chain of the PyTorch port (sim/fullsim.py and
harness.fullsim_main) against the JAX package on the same draws.

FullChainSim.trial takes the reference's own draws, replayed from its
per-trial split(key, 2 + 2R): [0] the TB bits, [1] the PHICH ACK bit,
[2 + 2r] round r's channel normals, [3 + 2r] round r's noise normals. Per
round errors and reach, the round-0 DCI misses and PHICH errors must be
equal to the reference's `_trial_step`; cold start's rates and MIB equal
on the same numpy draws; fullsim_main's CSV equal byte for byte when the
port's steps take the reference's draws. 25 PRB (6 for the command line),
batch 4, 4 turbo iterations, decoder window 96 on both sides. The points
are draws where no block sits on the turbo waterfall's edge (the two
decoders differ there; ROADMAP Queue 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.sim import harness as jh
from openair4g_tpu.sim.fullsim import FullChainSim as JSim
from openair4g_tpu.sim.fullsim import FullsimConfig as JConfig
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.sim import harness as h
from openair4g_tpu_torch.sim.fullsim import FullChainSim, FullsimConfig

torch.set_num_threads(1)

B = 4
# name: (config, [(SNR, seed)]): a point where every TB decodes in round
# 0 and one where HARQ rounds are exercised
CASES = {
    "AWGN": (dict(mcs=4, channel="AWGN", n_harq_rounds=1),
             [(6.0, 0), (-2.5, 1)]),
    "EVA 4 rounds": (dict(mcs=10, channel="EVA", n_harq_rounds=4),
                     [(30.0, 2), (6.0, 3)]),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def replay(jsim, keys):
    """The reference _trial_step's draws for `keys`."""
    cfg, cm = jsim.cfg, jsim.chan
    R = cfg.n_harq_rounds
    sp = jax.vmap(lambda k: jax.random.split(k, 2 + 2 * R))(keys)
    tb = jax.vmap(lambda k: jax.random.bernoulli(
        k, 0.5, (jsim.codec.cfg.tbs,)))(sp[:, 0]).astype(jnp.int32)
    ack = jax.vmap(lambda k: jax.random.bernoulli(k, 0.5, ()))(sp[:, 1])
    taps, noise = [], []
    for r in range(R):
        taps.append(None if cfg.channel == "AWGN" else _t(jax.vmap(
            lambda k: jax.random.normal(
                k, (cm.n_rx, cm.n_tx, cm.n_taps, 2)))(sp[:, 2 + 2 * r])))
        noise.append(_t(jax.vmap(lambda k: jax.random.normal(
            k, (jsim.fp.samples_per_tti, 2)))(sp[:, 3 + 2 * r])))
    return _t(tb), _t(ack).to(torch.int32), taps, noise


@pytest.mark.parametrize("case", sorted(CASES))
def test_trial_equals_reference(case):
    cfg, points = CASES[case]
    cfg = dict(n_rb=25, batch=B, n_turbo_iter=4, **cfg)
    jsim = JSim(JConfig(**cfg))
    sim = FullChainSim(FullsimConfig(**cfg, decoder_window=96), device="cpu")
    got_errs = []
    for snr, seed in points:
        n0 = np.float32(10.0 ** (-snr / 10.0))
        keys = jnp.asarray(host_keys(seed, B))
        jw = jnp.asarray(jsim.ue.make_wiener(float(n0)))
        want = [np.asarray(x) for x in jsim._step(keys, jnp.float32(n0), jw)]
        res = sim.trial(*replay(jsim, keys), float(n0),
                        sim.ue.make_wiener(float(n0)))
        got = [res.errs.numpy(), res.reach.numpy(), res.dci_miss.numpy(),
               res.phich_err.numpy()]
        for g, w, name in zip(got, want, ("errs", "reach", "dci_miss",
                                          "phich_err")):
            np.testing.assert_array_equal(g, w, err_msg=f"{case} {name}")
        # the per-round flags agree with the counts
        oks = torch.stack([r.ok for r in res.rounds])
        assert int((~oks[0]).sum()) == int(res.errs[0])
        got_errs.append(int(res.errs[0]))
    assert got_errs[0] == 0
    assert got_errs[1] > 0, "HARQ not exercised"


def test_soft_buffers_carry_across_rounds():
    """Round r's soft buffers are round r-1's plus its LLRs: a trial that
    decodes in round 1 has a larger buffer than round 0's."""
    sim = FullChainSim(FullsimConfig(n_rb=25, mcs=10, channel="EVA",
                                     n_harq_rounds=2, batch=B,
                                     n_turbo_iter=4), device="cpu")
    gen = torch.Generator().manual_seed(3)
    n0 = 10.0 ** -0.6
    res = sim.step(gen, n0, sim.ue.make_wiener(n0))
    for w0, w1 in zip(res.rounds[0].w_soft, res.rounds[1].w_soft):
        assert w0.shape == w1.shape
        assert float(w1.abs().sum()) > float(w0.abs().sum())


@pytest.mark.parametrize("snr,seed", [(10.0, 0), (-9.0, 1)])
def test_cold_start_equals_reference(snr, seed):
    """The same numpy draws on both sides: sync, timing and MIB rates and
    the MIB equal; at 10 dB every capture syncs, at -9 dB some do not."""
    cfg = dict(n_rb=25, mcs=4, batch=8)
    jsim = JSim(JConfig(**cfg))
    sim = FullChainSim(FullsimConfig(**cfg), device="cpu")
    want = jsim.cold_start(snr, batch=8, seed=seed)
    got = sim.cold_start(snr, batch=8, seed=seed)
    assert got == want
    if snr > 0:
        assert got["sync_rate"] == got["mib_rate"] == 1.0
        assert got["mib"]["n_rb"] == 25
    else:
        assert got["sync_rate"] < 1.0


def test_fullsim_command_line_csv_equals_reference(tmp_path, monkeypatch):
    """fullsim_main on the CPU, its steps fed the reference's draws for the
    same host_keys streams: the CSV equals the reference's byte for
    byte."""
    argv = ["-m", "0", "-B", "6", "-s", "-8", "-S", "-6", "-i", "2", "-n",
            "8", "-b", "4", "-r", "2", "--seed", "5"]
    want_csv, got_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    jrows = jh.fullsim_main(argv + ["-o", str(want_csv)])
    jsim = JSim(JConfig(n_rb=6, mcs=0, batch=4, n_harq_rounds=2))
    streams = iter(range(100))

    def draw(self, generator):
        return replay(jsim, jnp.asarray(host_keys(5, 4,
                                                  stream=next(streams) % 2)))
    monkeypatch.setattr(FullChainSim, "draw", draw)
    rows = h.fullsim_main(argv + ["-o", str(got_csv), "--device", "cpu"])
    assert got_csv.read_bytes() == want_csv.read_bytes()
    assert len(rows) == len(jrows)
    assert any(int(r[1][0]) for r in rows), "no error at the low SNR"


def test_fullsim_command_line_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        h.fullsim_main(["-B", "6", "-n", "4", "-b", "4"])


# ------------------------------------------------------------- framegen --

def test_generate_frame_equals_reference(tmp_path):
    """tests/test_tracking_rf.py's cell: the port's frame (grids on the
    host, one batched IFFT on the device) within 1e-5 of the reference's
    host frame; the command line writes the .npy and the Octave dump."""
    from openair4g_tpu.sched.enb_tx import CellConfig as JCell
    from openair4g_tpu.sim.framegen import generate_frame as j_frame
    from openair4g_tpu_torch.sched import CellConfig
    from openair4g_tpu_torch.sim import framegen
    from openair4g_tpu_torch.utils.octave_io import read_output
    cell = dict(n_rb=6, n_id_cell=5, n_prb=6, n_pdcch=3, dci_L=2)
    for sfn, fill in ((0, True), (2, False)):
        want = j_frame(JCell(**cell), sfn=sfn, fill_pdsch=fill, seed=3)
        got = framegen.generate_frame(CellConfig(**cell), sfn=sfn,
                                      fill_pdsch=fill, seed=3, device="cpu")
        assert got.dtype == np.complex64 and got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    npy, octave = tmp_path / "f.npy", tmp_path / "f.m"
    wave = framegen.main(["-B", "6", "-N", "5", "--pdsch", "-o", str(npy),
                          "--octave", str(octave), "--device", "cpu"])
    np.testing.assert_array_equal(np.load(npy), wave)
    np.testing.assert_allclose(read_output(str(octave))["txs"], wave,
                               rtol=1e-6, atol=1e-8)


# ------------------- the reference's Monte-Carlo checks through the port --

def test_fullsim_awgn_operating_point_through_the_port():
    """tests/test_fullsim.py's AWGN point with the port's draws."""
    sim = FullChainSim(FullsimConfig(n_rb=25, mcs=4, channel="AWGN",
                                     n_harq_rounds=1, batch=16,
                                     n_turbo_iter=6), device="cpu")
    errs, reach = sim.run_snr(6.0, 32)
    assert errs[0] == 0 and reach[0] == 32
    assert sim.dci_miss == 0 and sim.phich_err == 0


def test_fullsim_harq_gain_fading_through_the_port():
    """tests/test_fullsim.py's EVA HARQ point with the port's draws."""
    sim = FullChainSim(FullsimConfig(n_rb=25, mcs=10, channel="EVA",
                                     n_harq_rounds=3, batch=32,
                                     n_turbo_iter=6), device="cpu")
    errs, reach = sim.run_snr(6.0, 32)
    assert reach[0] == 32
    assert errs[-1] <= errs[0], (errs, reach)
