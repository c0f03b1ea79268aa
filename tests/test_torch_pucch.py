"""The rest of the uplink PHY of the PyTorch port against the JAX
reference on the same inputs: PUCCH formats 1a, 2, 2a and 2b with the
(20, A) block code, the SRS and its sounding estimate, power control, and
Pucchsim on the reference's replayed draws (per trial the data-symbol
noise normals from the trial's key and the RS noise normals from
split(key, 1)[0]), plus the pucchsim command line with --device cpu.

Decisions (ACK bits, decoded CQI payloads, timing-offset peaks, the
simulator's per-trial flags) must be equal; soft values are held within
the float32 tolerance stated at each check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.phy import power_control as j_pc
from openair4g_tpu.phy import pucch as j_pucch
from openair4g_tpu.phy import srs as j_srs
from openair4g_tpu.sim.pucchsim import Pucchsim as JPucchsim
from openair4g_tpu.sim.pucchsim import PucchsimConfig as JConfig
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.phy import power_control, pucch, srs
from openair4g_tpu_torch.sim.pucchsim import Pucchsim, PucchsimConfig, main

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

RNG = np.random.default_rng(31)


def _cplx(*shape):
    return (RNG.standard_normal(shape)
            + 1j * RNG.standard_normal(shape)).astype(np.complex64)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# ----------------------------------------------------------------- PUCCH --

@pytest.mark.parametrize("nid", [0, 17, 301])
def test_pucch_sequences_equal_reference(nid):
    np.testing.assert_array_equal(pucch.ncs_cell(nid), j_pucch.ncs_cell(nid))
    for ns in (0, 4, 9):
        for n_cs1, n_oc, d in ((0, 0, 1.0), (3, 1, -1.0), (6, 2, 1j)):
            for a, b in zip(pucch.pucch1_slot_symbols(nid, ns, n_cs1, n_oc,
                                                      d),
                            j_pucch.pucch1_slot_symbols(nid, ns, n_cs1, n_oc,
                                                        d)):
                np.testing.assert_array_equal(a, b)
        d5 = _cplx(5)
        for a, b in zip(pucch.pucch2_slot_symbols(nid, ns, 3, d5),
                        j_pucch.pucch2_slot_symbols(nid, ns, 3, d5)):
            np.testing.assert_array_equal(a, b)
        for ack in ((0,), (1,), (0, 1), (1, 0), (1, 1)):
            d_ack = pucch.pucch2x_ack_symbol(ack)
            assert d_ack == j_pucch.pucch2x_ack_symbol(ack)
            for a, b in zip(pucch.pucch2x_slot_symbols(nid, ns, 3, d5, d_ack),
                            j_pucch.pucch2x_slot_symbols(nid, ns, 3, d5,
                                                         d_ack)):
                np.testing.assert_array_equal(a, b)


def test_pucch_detectors_equal_reference():
    """pucch1_detect and pucch2_equalize within 1e-6 of scale;
    pucch2x_detect's ACK decisions equal, its outputs within 1e-6."""
    rx_d, rx_r = _cplx(64, 4, 12), _cplx(64, 3, 12)
    got = pucch.pucch1_detect(torch.from_numpy(rx_d), torch.from_numpy(rx_r),
                              17, 5, 3, 1)
    want = j_pucch.pucch1_detect(jnp.asarray(rx_d), jnp.asarray(rx_r), 17,
                                 5, 3, 1)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 1e-6
    rx_d, rx_r = _cplx(64, 5, 12), _cplx(64, 2, 12)
    got = pucch.pucch2_equalize(torch.from_numpy(rx_d),
                                torch.from_numpy(rx_r), 17, 5, 3)
    want = j_pucch.pucch2_equalize(jnp.asarray(rx_d), jnp.asarray(rx_r), 17,
                                   5, 3)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 1e-6
    for n_ack in (1, 2):
        got = pucch.pucch2x_detect(torch.from_numpy(rx_d),
                                   torch.from_numpy(rx_r), 17, 5, 3, n_ack)
        want = j_pucch.pucch2x_detect(jnp.asarray(rx_d), jnp.asarray(rx_r),
                                      17, 5, 3, n_ack)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert len(np.unique(got[2].numpy(), axis=0)) == 2 * n_ack
        assert _rel(got[0].numpy(), want[0]) < 1e-6
        assert _rel(got[1].numpy(), want[1]) < 1e-6


@pytest.mark.parametrize("A", [1, 4, 8, 11, 13])
def test_rm20_code_equals_reference(A):
    msgs = RNG.integers(0, 2, (32, A))
    code = np.stack([pucch.rm20_encode(m) for m in msgs])
    np.testing.assert_array_equal(
        code, np.stack([j_pucch.rm20_encode(m) for m in msgs]))
    sigma = np.linspace(0.2, 4.0, 32)[:, None]
    llr = ((1.0 - 2.0 * code) + sigma * RNG.standard_normal(code.shape)
           ).astype(np.float32)
    got = pucch.rm20_decode(torch.from_numpy(llr), A).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_pucch.rm20_decode(jnp.asarray(llr), A)))
    right = (got == msgs).all(axis=1)
    assert right[:4].all() and (A == 1 or not right.all())


# ------------------------------------------------------------------- SRS --

@pytest.mark.parametrize("cfg", [dict(n_rb=25, srs_bw_rb=20),
                                 dict(n_rb=25, srs_bw_rb=20, rb_offset=2,
                                      k_tc=1, n_cs=3, u=5),
                                 dict(n_rb=100, srs_bw_rb=96, k_tc=1)])
def test_srs_equals_reference(cfg):
    """Sequences and bins equal; the sounding estimate's LS channel within
    1e-5 of its scale and its SNR within 1e-3 dB (the noise floor is a sum
    less the peak, which cancels), its timing offsets equal."""
    c, jc = srs.SrsConfig(**cfg), j_srs.SrsConfig(**cfg)
    assert c.m_sc == jc.m_sc
    np.testing.assert_array_equal(srs.srs_sequence(c), j_srs.srs_sequence(jc))
    np.testing.assert_array_equal(srs.srs_bins(c), j_srs.srs_bins(jc))
    n_fft = {25: 512, 100: 2048}[cfg["n_rb"]]
    tx = srs.srs_fill_symbol(c, 8, n_fft, device="cpu")
    np.testing.assert_array_equal(
        tx.numpy(), np.asarray(j_srs.srs_fill_symbol(jc, 8, n_fft)))
    # delays of 0..7 samples and noise
    bins = srs.srs_bins(c)
    f = np.where(bins >= n_fft // 2, bins - n_fft, bins)
    delay = np.arange(8)[:, None]
    rot = np.exp(-2j * np.pi * f[None, :] * delay / n_fft)
    rx = tx.numpy().copy()
    rx[:, bins] *= (0.8 - 0.6j) * rot
    rx += 0.05 * _cplx(8, n_fft)
    got = srs.srs_estimate(torch.from_numpy(rx), c)
    want = j_srs.srs_estimate(jnp.asarray(rx), jc)
    assert _rel(got[0].numpy(), want[0]) < 1e-5
    assert np.abs(got[1].numpy() - np.asarray(want[1])).max() < 1e-3
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert np.abs(got[2].numpy() - np.arange(8)).max() <= 1.0


def test_power_control_equals_reference():
    for args in ((50, -85.0, 0.8, 110.0), (100, -60.0, 1.0, 120.0, 1.5, -2.0),
                 (6, -100.0, 0.7, 90.0, 0.0, 3.0, 20.0)):
        assert power_control.pusch_power_dbm(*args) == \
            j_pc.pusch_power_dbm(*args)
    for args in ((0, 100, 0), (200, 100), (7000, 3600, 1.25, 1.0)):
        assert power_control.delta_tf_db(*args) == j_pc.delta_tf_db(*args)
    for args in ((-96.0, 100.0), (-110.0, 130.0, 2.0, 1.0, -1.0, 21.0)):
        assert power_control.pucch_power_dbm(*args) == \
            j_pc.pucch_power_dbm(*args)
    assert power_control.srs_power_dbm(16, -90.0, 0.8, 100.0, 3.0) == \
        j_pc.srs_power_dbm(16, -90.0, 0.8, 100.0, 3.0)
    for acc in (True, False):
        a = power_control.ClosedLoopState(accumulate=acc)
        b = j_pc.ClosedLoopState(accumulate=acc)
        assert [a.apply_tpc(c) for c in (3, 0, 2, 1, 3)] == \
            [b.apply_tpc(c) for c in (3, 0, 2, 1, 3)]
    a, b = power_control.PrachRamping(), j_pc.PrachRamping()
    assert [a.next_power_dbm(120.0) for _ in range(5)] == \
        [b.next_power_dbm(120.0) for _ in range(5)]


# ------------------------------------------------------------- Pucchsim --

B = 64
# format: [(SNR, seed)], an operating point of tests/test_pucch.py and one
# where decisions fail
POINTS = {"1a": [(-8.0, 0), (-20.0, 1)], "2": [(-2.0, 0), (-8.0, 1)],
          "2a": [(0.0, 0), (-6.0, 1)], "2b": [(0.0, 0), (-6.0, 1)]}


def replay(jsim, keys):
    """The reference step's noise normals: data symbols from each trial's
    key, RS symbols from split(key, 1)[0]."""
    kk = jax.vmap(lambda k: jax.random.split(k, 1)[0])(keys)
    nd = jax.vmap(lambda k: jax.random.normal(
        k, jsim.tx_data.shape + (2,)))(keys)
    nr = jax.vmap(lambda k: jax.random.normal(
        k, jsim.tx_rs.shape + (2,)))(kk)
    return torch.from_numpy(np.array(nd)), torch.from_numpy(np.array(nr))


@pytest.mark.parametrize("fmt", sorted(POINTS))
def test_pucchsim_decisions_equal_reference(fmt):
    jsim = JPucchsim(JConfig(fmt=fmt, batch=B))
    sim = Pucchsim(PucchsimConfig(fmt=fmt, batch=B), device="cpu")
    assert tuple(sim.tx_data.shape) == jsim.tx_data.shape
    np.testing.assert_array_equal(sim.tx_data.numpy(), jsim.tx_data)
    np.testing.assert_array_equal(sim.tx_rs.numpy(), jsim.tx_rs)
    fails = []
    for snr, seed in POINTS[fmt]:
        n0 = np.float32(10.0 ** (-snr / 10.0))
        keys = jnp.asarray(host_keys(seed, B))
        want = np.asarray(jsim._jit(keys, jnp.float32(n0)))
        got = sim.trial(*replay(jsim, keys), n0).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{fmt} {snr} dB")
        fails.append(int((~got).sum()))
    assert fails[0] <= 0.05 * B and fails[1] > 0, fails


def test_pucchsim_command_line_on_the_cpu(capsys):
    rows = main(["-f", "2a", "-s", "-6", "-S", "0", "--step", "3", "-n", "1",
                 "--device", "cpu"])
    assert [r["snr_db"] for r in rows] == [-6.0, -3.0, 0.0]
    assert all(r["trials"] == 256 for r in rows)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and all("2a err" in line for line in out)


def test_pucchsim_command_line_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["-f", "1a"])
    assert e.value.code != 0
