"""PMCH/MBSFN of the PyTorch port against the JAX reference on the same
inputs: the MBSFN RE map and RS, the grid fill, the delay-domain smoother
and the channel estimate, the DL-SCH's MBSFN RE budget (g_override), the
SFN composite channel, and Mbmssim on the reference's replayed draws (per
trial split(key, 3): the TB bits' key, the channel's, split again into
the delays' and the amplitudes', and the noise's), plus the reference's
link points through the port, and the reference's BLER floor with the
MBSFN RS estimate at large delays.

Mbmssim's TB flags and bit errors must be equal; soft values are held
within the float32 tolerance stated at each check. The port's turbo
decoder follows the v2 kernel, not the JAX CPU decoder (ROADMAP watch
list), so the decoder window is pinned at 96 on the port's side and the
points are draws where no block sits on the edge of the waterfall."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.phy import pdsch as jpdsch
from openair4g_tpu.phy import pmch as jpm
from openair4g_tpu.sim.mbmssim import Mbmssim as JMbmssim
from openair4g_tpu.sim.mbmssim import MbmssimConfig as JConfig
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.phy import pdsch, pmch
from openair4g_tpu_torch.sim.mbmssim import Mbmssim, MbmssimConfig

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

RNG = np.random.default_rng(71)


def _cplx(*shape):
    return (RNG.standard_normal(shape)
            + 1j * RNG.standard_normal(shape)).astype(np.complex64)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n_rb,nid,sf", [(6, 0, 1), (25, 3, 2),
                                         (100, 0, 1)])
def test_mbsfn_map_and_rs_equal_reference(n_rb, nid, sf):
    m, j = pmch.make_mbsfn_map(n_rb, nid, sf), jpm.make_mbsfn_map(n_rb, nid,
                                                                  sf)
    assert m.n_data_re == j.n_data_re == 10 * 12 * n_rb - 3 * 6 * n_rb
    for f in ("data_sym", "data_sc", "data_bin", "rs_sym", "rs_sc", "rs_bin",
              "rs_val"):
        np.testing.assert_array_equal(getattr(m, f), getattr(j, f))
    for sym in pmch.MBSFN_RS_SYMS:
        np.testing.assert_array_equal(pmch.mbsfn_rs_values(nid, sf, sym, n_rb),
                                      jpm.mbsfn_rs_values(nid, sf, sym, n_rb))
    assert pmch.pmch_cinit(nid, sf) == jpm.pmch_cinit(nid, sf)
    x = _cplx(2, m.n_data_re)
    np.testing.assert_array_equal(
        pmch.mbsfn_fill_grid(torch.from_numpy(x), m).numpy(),
        np.asarray(jpm.mbsfn_fill_grid(jnp.asarray(x), j)))


@pytest.mark.parametrize("n_rb,n0", [(6, 1e-3), (25, 1e-2)])
def test_mbsfn_estimate_equals_reference(n_rb, n0):
    """The smoother (double, then complex64) equal; the estimate within
    1e-5 of its scale on a delayed channel with noise (each subcarrier
    takes its comb sample k // 2, so an odd one reads its neighbour's)."""
    np.testing.assert_array_equal(pmch._mbsfn_wiener(n_rb, n0),
                                  jpm._mbsfn_wiener(n_rb, n0))
    m = pmch.make_mbsfn_map(n_rb)
    fp = m.fp
    h = np.exp(-2j * np.pi * 0.05 * fp.cp * np.arange(fp.n_sc) / fp.n_fft)
    grid = pmch.mbsfn_fill_grid(torch.from_numpy(_cplx(3, m.n_data_re)),
                                m).numpy()
    bins = fp.sc_to_bin(np.arange(fp.n_sc))
    grid[:, :, bins] *= h
    grid = (grid + 0.05 * _cplx(*grid.shape)).astype(np.complex64)
    got = pmch.mbsfn_estimate_channel(torch.from_numpy(grid), m, n0).numpy()
    want = np.asarray(jpm.mbsfn_estimate_channel(
        jnp.asarray(grid), jpm.make_mbsfn_map(n_rb), n0))
    assert _rel(got, want) < 1e-5
    assert np.abs(got - h[m.data_sc]).mean() < 0.1


def test_g_override_sets_the_re_budget():
    for mcs, n_rb in ((4, 25), (22, 100)):
        g = pmch.make_mbsfn_map(n_rb).n_data_re * pdsch.DlschConfig(
            mcs=mcs, n_rb=n_rb).Qm
        cfg = pdsch.DlschConfig(mcs=mcs, n_rb=n_rb, g_override=g)
        assert cfg.G == jpdsch.DlschConfig(mcs=mcs, n_rb=n_rb,
                                           g_override=g).G == g
        codec, jcodec = pdsch.DlschCodec(cfg), jpdsch.DlschCodec(
            jpdsch.DlschConfig(mcs=mcs, n_rb=n_rb, g_override=g))
        assert codec.Es == jcodec.Es


B = 8
# name: (config, [(SNR, seed)]): a point where every TB decodes and, for
# the estimated channel, one where some do not
CASES = {
    "6 PRB 1 cell perfect CE": (dict(mcs=4, n_rb=6, n_sfn_cells=1,
                                     max_delay_frac=0.0, perfect_ce=True,
                                     n_turbo_iter=6), [(25.0, 0)]),
    "25 PRB 3 cells estimated CE": (dict(mcs=4, n_rb=25, n_sfn_cells=3,
                                         max_delay_frac=0.6, n_turbo_iter=6),
                                    [(20.0, 0), (0.0, 1)]),
}
# The MBSFN RS estimate's floor at delays to 0.8 of the extended CP (each
# subcarrier takes comb sample k // 2, an odd one its neighbour's phase):
# at 40 dB TBs fail on both sides alike, at 25 PRB 16QAM and at the
# 100 PRB MCS 22 full width; with the channel known every one decodes.
FLOOR = {"25 PRB MCS 10": (dict(mcs=10, n_rb=25), 8),
         "100 PRB MCS 22": (dict(mcs=22, n_rb=100), 4)}


def replay(jsim, keys):
    """The reference step's draws, split as its step splits them."""
    cfg = jsim.cfg
    T = jsim.fp.samples_per_tti

    def one(key):
        s = jax.random.split(key, 3)
        k1, k2 = jax.random.split(s[1])
        return (jax.random.bernoulli(s[0], 0.5, (jsim.codec.cfg.tbs,))
                .astype(jnp.int32),
                jax.random.uniform(k1, (1, cfg.n_sfn_cells))[0],
                jax.random.normal(k2, (1, cfg.n_sfn_cells, 2))[0],
                jax.random.normal(s[2], (T, 2)))
    return [torch.from_numpy(np.array(x)) for x in jax.vmap(one)(keys)]


def test_sfn_channel_equals_reference():
    """The composite channel within 1e-5 of its scale on the same draws
    (its phases reach a few hundred radians in float32)."""
    cfg = dict(mcs=4, n_rb=25, n_sfn_cells=3, max_delay_frac=0.8, batch=B)
    jsim = JMbmssim(JConfig(**cfg))
    sim = Mbmssim(MbmssimConfig(**cfg), device="cpu")
    keys = jnp.asarray(host_keys(5, B))
    _, u, a, _ = replay(jsim, keys)
    want = jax.vmap(lambda k: jsim._sfn_channel(
        jax.random.split(k, 3)[1], 1)[0])(keys)
    assert _rel(sim.sfn_channel(u, a).numpy(), want) < 1e-5


@pytest.mark.parametrize("case", sorted(CASES))
def test_mbmssim_equals_reference(case):
    cfg, points = CASES[case]
    cfg = {"batch": B, **cfg}
    jsim = JMbmssim(JConfig(**cfg))
    sim = Mbmssim(MbmssimConfig(**cfg, decoder_window=96), device="cpu")
    np.testing.assert_array_equal(sim.scr_seq, jsim.scr_seq)
    assert sim.codec.cfg.G == jsim.codec.cfg.G
    fails = []
    for snr, seed in points:
        n0 = np.float32(10.0 ** (-snr / 10.0))
        keys = jnp.asarray(host_keys(seed, B))
        ok_w, errs_w = (np.asarray(x) for x in
                        jsim._step(keys, jnp.float32(n0)))
        ok, errs = sim.trial(*replay(jsim, keys), n0)
        np.testing.assert_array_equal(ok.numpy(), ok_w, err_msg=case)
        np.testing.assert_array_equal(errs.numpy(), errs_w, err_msg=case)
        fails.append(int((~ok).sum()))
    assert fails[0] == 0, fails
    if len(fails) > 1:
        assert 0 < fails[-1], fails


@pytest.mark.parametrize("case", sorted(FLOOR))
def test_mbsfn_estimate_floor_is_the_reference_s(case):
    """With the estimate the TB flags equal the reference's and many fail;
    with the channel known (the port's own run) every TB decodes."""
    cfg, batch = FLOOR[case]
    cfg = dict(cfg, n_sfn_cells=3, max_delay_frac=0.8, batch=batch)
    keys = jnp.asarray(host_keys(0, batch))
    n0 = np.float32(1e-4)
    jsim = JMbmssim(JConfig(**cfg))
    draws = replay(jsim, keys)
    want = np.asarray(jsim._step(keys, jnp.float32(n0))[0])
    got = Mbmssim(MbmssimConfig(**cfg, decoder_window=96),
                  device="cpu").trial(*draws, n0)[0].numpy()
    np.testing.assert_array_equal(got, want, err_msg=case)
    assert (~got).sum() >= batch // 2, got
    known = Mbmssim(MbmssimConfig(**cfg, perfect_ce=True, decoder_window=96),
                    device="cpu").trial(*draws, n0)[0]
    assert bool(known.all()), known


def test_mbms_link_points_through_the_port():
    """tests/test_mbms.py's two link points with the port's draws."""
    sim = Mbmssim(MbmssimConfig(mcs=4, n_rb=6, n_sfn_cells=1,
                                max_delay_frac=0.0, batch=16, n_turbo_iter=6,
                                perfect_ce=True), device="cpu")
    errs, trials = sim.run_snr(25.0, 16)
    assert errs <= 1, (errs, trials)
    sim = Mbmssim(MbmssimConfig(mcs=4, n_rb=25, n_sfn_cells=3,
                                max_delay_frac=0.6, batch=16,
                                n_turbo_iter=6), device="cpu")
    errs, trials = sim.run_snr(20.0, 16)
    assert errs <= trials * 0.5, (errs, trials)
