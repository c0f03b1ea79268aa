"""The uplink simulator as a whole: Ulsim.trial of the PyTorch port
against the JAX simulator's jitted `_trial_step` on the same draws (TB
bits, UCI bits, per round the channel and noise normals), replayed from
the reference's own key splits: split(k, 2 + 2R) per trial, TB bits from
split 0, the UCI bits from split(split 1, 3), per round r the taps from
split 2 + 2r and the noise from split 3 + 2r.

6 PRB, batch 8, 4 turbo iterations, decoder window 96 on both sides: data
only on AWGN over 2 HARQ rounds, UCI on the (32, O) Reed-Muller path
(o_cqi 8, o_ri 1, o_ack 2) on AWGN, and UCI on the CRC8 + convolutional
path (o_cqi 20, o_ack 1) on EVA over 2 rounds; the hopping, time-domain
and genie-channel modes are in test_torch_ulsim_channels.py. At 30 dB and
at SNRs where round 0 fails for part of the batch (and, for the UCI
modes, where UCI fields fail), the per-round errs and reach and the UCI
error counts must be equal.

The decoder-input LLRs agree with the reference's to about 1e-6 of their
scale, but the port's turbo decoder is not the JAX CPU decoder: it
follows the v2 kernel, whose window-end nodes differ from the XLA oracle's
(ROADMAP watch list). A block on the edge of a steep AWGN waterfall can
then decode on one side and not on the other; the moderate points below
are draws where none does, and the last test shows that such a difference
is the decoders' alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.ops.gold import scramble_bits as j_scramble
from openair4g_tpu.ops.uci import UciConfig as JUciConfig
from openair4g_tpu.phy import ofdm as j_ofdm
from openair4g_tpu.phy.pusch import make_ul_wiener as j_wiener
from openair4g_tpu.phy.pusch import scfdma_mmse_equalize as j_equalize
from openair4g_tpu.phy.pusch import ul_estimate_channel as j_estimate
from openair4g_tpu.phy.scfdma import pusch_extract as j_extract
from openair4g_tpu.phy.scfdma import pusch_fill_grid_x as j_fill
from openair4g_tpu.phy.scfdma import transform_deprecode as j_deprecode
from openair4g_tpu.sim.channels import apply_channel_bins as j_bins
from openair4g_tpu.sim.ulsim import Ulsim as JUlsim
from openair4g_tpu.sim.ulsim import UlsimConfig as JConfig
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.ops.uci import UciConfig
from openair4g_tpu_torch.sim.ulsim import Ulsim, UlsimConfig

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

B = 8
COMMON = dict(batch=B, n_turbo_iter=4)
# mode: (config, [(moderate SNR in dB, seed)])
MODES = {
    "data_awgn_2_rounds": (dict(mcs=16, n_rb=6, n_rb_alloc=6,
                                channel="AWGN", n_harq_rounds=2),
                           [(7.25, 2)]),
    "uci_rm_awgn": (dict(mcs=12, n_rb=6, n_rb_alloc=6, channel="AWGN",
                         uci=(8, 1, 2)), [(4.5, 1), (-6.0, 1)]),
    "uci_cc_eva_2_rounds": (dict(mcs=10, n_rb=6, n_rb_alloc=6,
                                 channel="EVA", uci=(20, 0, 1),
                                 n_harq_rounds=2), [(0.0, 1)]),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def make_pair(cfg: dict):
    """The reference's Ulsim and the port's on the CPU, window 96."""
    cfg = {**COMMON, **cfg}
    u = cfg.pop("uci", None)
    jcfg, pcfg = dict(cfg), dict(cfg)
    if u is not None:
        jcfg["uci"] = JUciConfig(o_cqi=u[0], o_ri=u[1], o_ack=u[2])
        pcfg["uci"] = UciConfig(o_cqi=u[0], o_ri=u[1], o_ack=u[2])
    return (JUlsim(JConfig(**jcfg)),
            Ulsim(UlsimConfig(**pcfg, decoder_window=96), device="cpu"))


def replay(jsim, keys):
    """The reference _trial_step's draws for `keys`: TB bits, the UCI bits
    dict, and per round the tap normals (None for AWGN) and the noise
    normals."""
    cfg, cm = jsim.cfg, jsim.chan
    R = cfg.n_harq_rounds
    sp = jax.vmap(lambda k: jax.random.split(k, 2 + 2 * R))(keys)
    tb = jax.vmap(lambda k: jax.random.bernoulli(
        k, 0.5, (jsim.ulsch.tbs,)))(sp[:, 0]).astype(jnp.int32)
    uci = {}
    if jsim.uci_maps is not None:
        uk = jax.vmap(lambda k: jax.random.split(k, 3))(sp[:, 1])
        u = cfg.uci
        for i, (name, n) in enumerate((("cqi", u.o_cqi), ("ri", u.o_ri),
                                       ("ack", u.o_ack))):
            if n:
                uci[name] = _t(jax.vmap(lambda k, n=n: jax.random.bernoulli(
                    k, 0.5, (n,)))(uk[:, i]).astype(jnp.int32))
    taps, noise = [], []
    for r in range(R):
        taps.append(None if cm.name == "AWGN" else _t(jax.vmap(
            lambda k: jax.random.normal(k, (1, 1, cm.n_taps, 2)))(
                sp[:, 2 + 2 * r])))
        noise.append(_t(jax.vmap(lambda k: jax.random.normal(
            k, (jsim.fp.samples_per_tti, 2)))(sp[:, 3 + 2 * r])))
    return _t(tb), uci, taps, noise


def run_both(jsim, sim, snr_db: float, seed: int):
    """(reference errs, reach, uci_errs) and the port's trial result."""
    n0 = 10.0 ** (-snr_db / 10.0)
    keys = jnp.asarray(host_keys(seed, B))
    want = [np.asarray(x).tolist() for x in jsim._step(
        keys, jnp.float32(n0), jnp.asarray(j_wiener(jsim.pm, n0)))]
    got = sim.trial(*replay(jsim, keys), n0, sim.wiener(snr_db))
    return want, got


def check_equal(want, got):
    assert got.errs.tolist() == want[0], (got.errs, want)
    assert got.reach.tolist() == want[1], (got.reach, want)
    assert got.uci_errs.tolist() == want[2], (got.uci_errs, want)
    assert got.ok.shape == (len(want[0]), B)


@pytest.fixture(scope="module", params=sorted(MODES))
def pair(request):
    cfg, points = MODES[request.param]
    return (request.param, points) + make_pair(cfg)


def test_counts_equal_reference_at_high_snr(pair):
    _, _, jsim, sim = pair
    want, got = run_both(jsim, sim, 30.0, seed=0)
    check_equal(want, got)
    R = jsim.cfg.n_harq_rounds
    assert got.errs.tolist() == [0] * R and got.uci_errs.tolist() == [0] * 3
    assert got.reach.tolist() == [B] + [0] * (R - 1)


def test_counts_equal_reference_at_moderate_snr(pair):
    mode, points, jsim, sim = pair
    partial = uci_fail = False
    for snr, seed in points:
        want, got = run_both(jsim, sim, snr, seed)
        check_equal(want, got)
        partial |= 0 < got.errs[0] < B
        uci_fail |= int(got.uci_errs.sum()) > 0
    assert partial                             # HARQ and decoding exercised
    assert uci_fail == mode.startswith("uci")


def test_waterfall_edge_difference_is_the_decoders():
    """16QAM data on AWGN at 7.5 dB, a draw where one block of 8 decodes
    in the reference and not in the port: the decoder-input LLRs agree to
    1e-5 of their scale, the reference's decoder on the port's LLRs gives
    the reference's flags, the port's on the reference's the port's."""
    cfg = dict(mcs=16, n_rb=6, n_rb_alloc=6, channel="AWGN")
    jsim, sim = make_pair(cfg)
    snr, n0 = 7.5, 10.0 ** -0.75
    keys = jnp.asarray(host_keys(2, B))
    tb, _, _, noise = replay(jsim, keys)
    # the reference's round 0 step by step, eagerly
    tbj = jnp.asarray(tb.numpy())
    e = j_scramble(jsim.codec.select_e(jsim.codec.encode_to_d(tbj), 0),
                   jsim.scr_data)
    grid = j_fill(jsim._tx_symbols(e, {}), jsim.pm, jsim.dmrs)
    grid = j_bins(grid, jnp.ones((B, jsim.pm.m_sc), jnp.complex64),
                  jsim.pm.sc_bins, jsim.fp.n_fft)
    nr = jnp.asarray(noise[0].numpy())
    rx = j_ofdm.ofdm_modulate(grid, jsim.fp) + jnp.sqrt(
        jnp.float32(n0) / 2) * (nr[..., 0] + 1j * nr[..., 1])
    y, dm = j_extract(j_ofdm.ofdm_demodulate(rx, jsim.fp), jsim.pm)
    H = j_estimate(dm, jsim.dmrs, jsim.pm, jnp.asarray(j_wiener(jsim.pm,
                                                                n0)))
    xf, n0_eff = j_equalize(y, H, jnp.float32(n0))
    want_llr = np.array(jsim._rx_llrs(j_deprecode(xf), n0_eff)[0])
    got_llr, _ = sim.round_llrs(0, sim.codec.encode_to_d(tb), {}, None,
                                noise[0], float(np.float32(n0)),
                                sim.wiener(snr))
    rel = np.abs(got_llr.numpy() - want_llr).max() / np.abs(want_llr).max()
    assert rel < 1e-5, rel
    j_ok = np.asarray(jsim.codec.decode(jnp.asarray(want_llr))[1])
    p_ok = sim.codec.decode(got_llr)[1].numpy()
    np.testing.assert_array_equal(
        np.asarray(jsim.codec.decode(jnp.asarray(got_llr.numpy()))[1]), j_ok)
    np.testing.assert_array_equal(
        sim.codec.decode(torch.from_numpy(want_llr))[1].numpy(), p_ok)
    assert 0 < j_ok.sum() < B and 0 < p_ok.sum() < B


def test_time_domain_channel_with_hopping_or_genie_raises():
    """The reference asserts this inside its jitted step; the port refuses
    the configuration at construction."""
    for extra in (dict(perfect_ce=True),
                  dict(n_rb_alloc=6, rb_offset=2, hopping_bits=0)):
        with pytest.raises(ValueError):
            Ulsim(UlsimConfig(n_rb=25, channel="EVA",
                              time_domain_channel=True, **extra),
                  device="cpu")


def test_step_and_sweep_run_on_the_cpu():
    """draw/step on the simulator's own device; sweep's rows and its
    early exit."""
    sim = Ulsim(UlsimConfig(mcs=12, n_rb=6, n_rb_alloc=6, batch=4,
                            n_turbo_iter=2, n_harq_rounds=2,
                            uci=UciConfig(o_cqi=16, o_ack=1)), device="cpu")
    res = sim.step(torch.Generator().manual_seed(3), 10 ** -2.5,
                   sim.wiener(25.0))
    assert res.errs.tolist() == [0, 0] and res.uci_errs.tolist() == [0] * 3
    rows = sim.sweep([25.0, 26.0], 4, verbose=False)
    assert len(rows) == 1 and rows[0][2].tolist() == [4, 0]
