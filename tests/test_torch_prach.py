"""The PRACH of the PyTorch port against the JAX reference on the same
inputs: the root-sequence table (a copy), the sequences, the restricted
set, the preamble map, the FDD configuration table, the RE-level
correlator, the time-domain phasor and sample path, and Prachsim on the
reference's replayed draws (per trial split(key, 3): the preamble's key,
the delay's and the noise's) on every path, the ROC's energies, the
prachsim command line with --device cpu, and the reference's operating
points through the port.

Detections and delays must be equal. The phasor matrix E is float32 at
a large argument (t (k0 + m) reaches about 4.5e4 rad at 20 MHz) and both
sides evaluate the same float32 expression, whose last-bit roundings
differ: E is held per element within 1e-2 / sqrt(N), its sqrt(N) scale
being 1. Other soft values are held within the tolerance stated at each
check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.phy import prach as jpr
from openair4g_tpu.sim.prachsim import Prachsim as JPrachsim
from openair4g_tpu.sim.prachsim import PrachsimConfig as JConfig
from openair4g_tpu.tables import prach_root_map as jroot
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.phy import prach as pr
from openair4g_tpu_torch.sim.prachsim import Prachsim, PrachsimConfig, main
from openair4g_tpu_torch.tables import prach_root_map as root

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

RNG = np.random.default_rng(67)


def _cplx(*shape):
    return (RNG.standard_normal(shape)
            + 1j * RNG.standard_normal(shape)).astype(np.complex64)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# ----------------------------------------------------------------- tables --

def test_root_tables_and_sequences_equal_reference():
    assert root.ROOT_ORDER_0_3 == jroot.ROOT_ORDER_0_3
    assert root.ROOT_ORDER_4 == jroot.ROOT_ORDER_4
    for u, n_zc in ((129, 839), (500, 839), (3, 139)):
        np.testing.assert_array_equal(pr.zc_root(u, n_zc),
                                      jpr.zc_root(u, n_zc))
        np.testing.assert_array_equal(pr.preamble(u, 5, 13, n_zc),
                                      jpr.preamble(u, 5, 13, n_zc))
        np.testing.assert_array_equal(pr.preamble_freq(u, 5, 13, n_zc),
                                      jpr.preamble_freq(u, 5, 13, n_zc))
        assert pr.zc_du(u, n_zc) == jpr.zc_du(u, n_zc)
    assert pr.n_preambles(13) == jpr.n_preambles(13) == 64
    for u in (1, 129, 131, 300, 500, 838):
        for ncs in pr.NCS_RESTRICTED:
            assert pr.restricted_shifts(u, ncs) == \
                jpr.restricted_shifts(u, ncs)


@pytest.mark.parametrize("high_speed,fmt", [(False, 0), (True, 0),
                                            (False, 4)])
def test_preamble_map_equals_reference(high_speed, fmt):
    n_cfg = len(pr.NCS_FORMAT4 if fmt == 4 else pr.NCS_RESTRICTED
                if high_speed else pr.NCS_UNRESTRICTED)
    for idx in (0, 17, 400):
        for ncs_config in range(n_cfg):
            assert pr.preamble_map(idx, ncs_config, high_speed, fmt) == \
                jpr.preamble_map(idx, ncs_config, high_speed, fmt)


def test_fdd_config_table_equals_reference():
    for idx in range(64):
        try:
            want = jpr.prach_fdd_config(idx)
        except ValueError:
            with pytest.raises(ValueError):
                pr.prach_fdd_config(idx)
            continue
        assert pr.prach_fdd_config(idx) == want
        for sfn, sf in ((0, 1), (1, 4), (2, 9), (3, 0)):
            assert pr.is_prach_occasion(idx, sfn, sf) == \
                jpr.is_prach_occasion(idx, sfn, sf)


# --------------------------------------------------------------- detection --

@pytest.mark.parametrize("u,ncs,n_zc,high_speed", [(129, 13, 839, False),
                                                   (500, 15, 839, True),
                                                   (3, 2, 139, False)])
def test_prach_detect_equals_reference(u, ncs, n_zc, high_speed):
    """Detections and delays equal; energies within 1e-5 of their scale,
    on preambles at every delay of their zone in noise from weak to
    strong."""
    shifts = pr.restricted_shifts(u, ncs) if high_speed else None
    cvs = shifts or [v * ncs for v in range(pr.n_preambles(ncs, n_zc))]
    B = 32
    v = RNG.integers(0, len(cvs), B)
    dly = RNG.integers(0, ncs, B)
    k = np.arange(n_zc)
    x = np.stack([(pr._dft(n_zc) @ pr.preamble_shifted(u, cvs[i], n_zc))
                  * np.exp(-2j * np.pi * k * d / n_zc)
                  for i, d in zip(v, dly)])
    x = (x + np.linspace(0.1, 8.0, B)[:, None] * _cplx(B, n_zc)
         ).astype(np.complex64)
    got = pr.prach_detect(torch.from_numpy(x), u, ncs, 15.0, n_zc, shifts)
    want = jpr.prach_detect(jnp.asarray(x), u, ncs, 15.0, n_zc, shifts)
    assert _rel(got[0].numpy(), want[0]) < 1e-5
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    det = got[2].numpy()[np.arange(B), v]
    assert det[:4].all() and not det.all()
    assert (got[1].numpy()[np.arange(B), v][:4] == dly[:4]).all()


# -------------------------------------------------------------- time domain --

@pytest.mark.parametrize("n_fft,fmt,n_ra_prb,n_rb_ul",
                         [(256, 0, 1, 25), (256, 4, 1, 25),
                          (2048, 0, 0, 100)])
def test_phasor_equals_reference(n_fft, fmt, n_ra_prb, n_rb_ul):
    """E per element within 1e-2 / sqrt(N) of the reference's (at 20 MHz,
    n_fft 2048 and 100 PRB, k0 = -7,187 and N = 24,576)."""
    n_zc = pr.N_ZC_F4 if fmt == 4 else pr.N_ZC
    N = pr.prach_samples_per_seq(n_fft, fmt)
    assert pr.prach_k0(n_ra_prb, n_rb_ul, fmt) == \
        jpr.prach_k0(n_ra_prb, n_rb_ul, fmt)
    got = pr._phasor(n_fft, fmt, n_ra_prb, n_rb_ul, n_zc).numpy()
    want = np.asarray(jpr._phasor(n_fft, fmt, n_ra_prb, n_rb_ul, n_zc))
    assert got.shape == want.shape == (N, n_zc)
    err = np.abs(got - want).max() * np.sqrt(N)
    assert err < 1e-2, err


@pytest.mark.parametrize("fmt", [0, 1, 2, 3, 4])
def test_time_domain_path_equals_reference(fmt):
    """The burst and its bins back within 1e-2 of their scale (the
    phasor's tolerance: each burst sample is a sum of N_ZC terms of E);
    detections and delays equal, a preamble delayed by whole samples found
    at its ZC delay +-1."""
    n_zc = pr.N_ZC_F4 if fmt == 4 else pr.N_ZC
    u, ncs = (3, 2) if fmt == 4 else (129, 13)
    xf = np.stack([pr.preamble_freq(u, v, ncs, n_zc) for v in (1, 7)])
    s = pr.prach_time_generate(torch.from_numpy(xf), 256, fmt, 1, 25)
    js = jpr.prach_time_generate(jnp.asarray(xf), 256, fmt, 1, 25)
    assert _rel(s.numpy(), js) < 1e-2
    N = pr.prach_samples_per_seq(256, fmt)
    shift = int(round(1 * N / n_zc))
    rx = torch.roll(s, shift, dims=-1) + 0.05 * torch.from_numpy(
        _cplx(*s.shape))
    bins = pr.prach_time_to_bins(rx, 256, fmt, 1, 25, n_zc)
    jbins = jpr.prach_time_to_bins(jnp.asarray(rx.numpy()), 256, fmt, 1, 25,
                                   n_zc)
    assert _rel(bins.numpy(), jbins) < 1e-2
    got = pr.prach_time_detect(rx, 256, fmt, 1, 25, u, ncs, n_zc=n_zc)
    want = jpr.prach_time_detect(jnp.asarray(rx.numpy()), 256, fmt, 1, 25,
                                 u, ncs, n_zc=n_zc)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2][0, 1] and got[2][1, 7] and int(got[2].sum()) == 2
    assert abs(int(got[1][1, 7]) - 1) <= 1


# --------------------------------------------------------------- Prachsim --

B = 32
# name: (config, [(SNR, seed)]): a point where every preamble is found and
# one where some are not
CASES = {
    "RE level": (dict(), [(-12.0, 0), (-24.0, 1)]),
    "restricted": (dict(root_u=500, ncs=15, high_speed=True), [(-18.0, 2)]),
    "format 4": (dict(root_u=3, ncs=15, fmt=4, max_delay=6), [(-8.0, 3)]),
    "time domain": (dict(time_domain=True, n_fft=256, batch=16),
                    [(-8.0, 4), (-22.0, 5)]),
    "time domain CFO": (dict(time_domain=True, n_fft=256, cfo_hz=300.0,
                             batch=16), [(-12.0, 6)]),
    "time domain 20 MHz": (dict(time_domain=True, n_fft=2048, n_rb_ul=100,
                                batch=4), [(-14.0, 7)]),
}


def replay(jsim, keys):
    """The reference step's draws: per trial split(key, 3) into the
    preamble's, the delay's and the noise's keys."""
    cfg = jsim.cfg
    n = jsim.n_zc
    if cfg.time_domain:
        xf = jnp.asarray(jsim.pre_f[:1])
        n = jpr.prach_time_generate(xf, cfg.n_fft, cfg.fmt, cfg.n_ra_prb,
                                    cfg.n_rb_ul).shape[-1]

    def one(key):
        kv, kd, kn = jax.random.split(key, 3)
        return (jax.random.randint(kv, (), 0, jsim.npre),
                jax.random.randint(kd, (), 0, cfg.max_delay + 1),
                jax.random.normal(kn, (n, 2)))
    return [torch.from_numpy(np.array(x)) for x in jax.vmap(one)(keys)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_prachsim_equals_reference(case):
    cfg, points = CASES[case]
    cfg = {"batch": B, **cfg}
    jsim = JPrachsim(JConfig(**cfg))
    sim = Prachsim(PrachsimConfig(**cfg), device="cpu")
    assert sim.shifts == jsim.shifts
    np.testing.assert_array_equal(sim.pre_f.numpy(), jsim.pre_f)
    dets = []
    for snr, seed in points:
        n0 = np.float32(10.0 ** (-snr / 10.0))
        keys = jnp.asarray(host_keys(seed, cfg["batch"]))
        want = [np.asarray(x) for x in jsim._jit(keys, jnp.float32(n0))]
        draws = replay(jsim, keys)
        assert draws[2].shape[1] == sim.n_samples
        got = [x.numpy() for x in sim.trial(*draws, n0)]
        for g, w, name in zip(got, want, ("det", "delay_ok", "n_false")):
            np.testing.assert_array_equal(g, w, err_msg=f"{case} {name}")
        dets.append(int(got[0].sum()))
    assert dets[0] == cfg["batch"] or len(points) == 1, dets
    if len(points) > 1:
        assert dets[-1] < cfg["batch"], dets


def test_roc_energies_equal_reference():
    """The ROC's signal and noise-only energies within 1e-5 of their scale
    on the same draws; its thresholds order the false alarms."""
    cfg = dict(batch=B)
    jsim = JPrachsim(JConfig(**cfg))
    sim = Prachsim(PrachsimConfig(**cfg), device="cpu")
    keys = jnp.asarray(host_keys(9, B))
    n0 = np.float32(10.0 ** 0.8)
    v, dly, noise = replay(jsim, keys)
    for signal in (True, False):
        want, jv = jsim._energies(keys, jnp.float32(n0), signal)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        got = sim.energies(v, dly, noise, n0, signal)
        assert _rel(got.numpy(), want) < 1e-5
    rows = sim.roc(-8.0, [6.0, 15.0, 25.0], n_batches=1)
    fas = [r["fa_per_occasion"] for r in rows]
    assert fas[0] >= fas[1] >= fas[2] and rows[1]["det_rate"] >= 0.99


def test_prachsim_command_line_on_the_cpu(capsys):
    rows = main(["-s", "-12", "-S", "-10", "-n", "1",
                 "--time-domain", "--device", "cpu"])
    assert [r["snr_db"] for r in rows] == [-12.0, -10.0]
    assert all(r["trials"] == 64 for r in rows)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all("delay_ok" in line for line in out)


def test_prach_operating_points_through_the_port():
    """tests/test_prach.py's link points with the port's draws."""
    sim = Prachsim(PrachsimConfig(batch=32), device="cpu")
    r = sim.run_snr(-12.0, n_batches=1)
    assert r["det_rate"] >= 0.95 and r["delay_ok_rate"] >= 0.9 \
        and r["false_per_trial"] <= 0.1
    assert sim.run_snr(-26.0, n_batches=1)["det_rate"] <= 0.5
    r = Prachsim(PrachsimConfig(time_domain=True, batch=16, n_fft=256),
                 device="cpu").run_snr(-8.0, n_batches=1)
    assert r["det_rate"] >= 0.95 and r["delay_ok_rate"] >= 0.9
    r = Prachsim(PrachsimConfig(root_u=500, ncs=15, high_speed=True,
                                max_delay=10, batch=16),
                 device="cpu").run_snr(-10.0, n_batches=1)
    assert r["det_rate"] >= 0.95
