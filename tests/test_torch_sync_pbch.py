"""Cell search and the PBCH of the PyTorch port against the JAX reference
on the same inputs: the PSS/SSS sequences and replicas, CellSearch, the
CFO estimate, the MIB and PBCH coding and blind decode, Pbchsim and
Syncsim on the reference's replayed draws (Pbchsim: the noise normals
from each trial's key; Syncsim: split(key) into the offset's key and the
noise's), CarrierScan on the same captures, the pbchsim and syncsim
command lines with --device cpu, and the reference's operating points
through the port.

Decisions (cell IDs, half-frame flags, timing, CRC flags, MIB bits,
frame phases, antenna counts) must be equal; soft values are held within
the float32 tolerance stated at each check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.phy import pbch as jpb
from openair4g_tpu.phy import sync as jsy
from openair4g_tpu.phy.channel_est import make_wiener_stack as j_wiener
from openair4g_tpu.sim.pbchsim import Pbchsim as JPbchsim
from openair4g_tpu.sim.pbchsim import PbchsimConfig as JPbchConfig
from openair4g_tpu.sim.scansim import CarrierScan as JCarrierScan
from openair4g_tpu.sim.scansim import ScanConfig as JScanConfig
from openair4g_tpu.sim.syncsim import Syncsim as JSyncsim
from openair4g_tpu.sim.syncsim import SyncsimConfig as JSyncConfig
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.config import FrameParms
from openair4g_tpu_torch.phy import pbch, sync
from openair4g_tpu_torch.sim import pbchsim, syncsim
from openair4g_tpu_torch.sim.pbchsim import Pbchsim, PbchsimConfig
from openair4g_tpu_torch.sim.scansim import CarrierScan, ScanConfig
from openair4g_tpu_torch.sim.syncsim import Syncsim, SyncsimConfig

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

RNG = np.random.default_rng(53)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# -------------------------------------------------------------- sequences --

def test_sync_sequences_equal_reference():
    for nid2 in range(3):
        np.testing.assert_array_equal(sync.pss_sequence(nid2),
                                      jsy.pss_sequence(nid2))
        for n_fft in (128, 512, 2048):
            np.testing.assert_array_equal(sync.pss_time_replica(nid2, n_fft),
                                          jsy.pss_time_replica(nid2, n_fft))
        for nid1 in (0, 29, 30, 111, 167):
            assert sync._m0_m1(nid1) == jsy._m0_m1(nid1)
            for half in (False, True):
                np.testing.assert_array_equal(
                    sync.sss_sequence(nid1, nid2, half),
                    jsy.sss_sequence(nid1, nid2, half))
    for n_rb in (6, 25, 100):
        np.testing.assert_array_equal(sync.center62_bins(FrameParms(n_rb)),
                                      jsy.center62_bins(FrameParms(n_rb)))


# ----------------------------------------------------------- cell search --

def _captures(n_rb, nid1, nid2, B, snr_db, cfo=0.0, seed=0):
    """[B, capture_len] captures of the Syncsim waveform at random offsets
    with a CFO and AWGN, made in numpy."""
    sim = Syncsim(SyncsimConfig(n_rb=n_rb, nid1=nid1, nid2=nid2),
                  device="cpu")
    rng = np.random.default_rng(seed)
    L = sim.search.capture_len
    wave = sim.subframe_t.numpy()
    cap = np.zeros((B, L), np.complex64)
    offs = rng.integers(0, sim.max_off, B)
    for b, o in enumerate(offs):
        cap[b, o:o + len(wave)] = wave
    cap *= np.exp(2j * np.pi * cfo / sim.fp.n_fft * np.arange(L))
    n0 = 10.0 ** (-snr_db / 10.0)
    cap += np.sqrt(n0 / 2) * (rng.standard_normal((B, L))
                              + 1j * rng.standard_normal((B, L)))
    return cap.astype(np.complex64), offs + sim.pss_t0


@pytest.mark.parametrize("n_rb,nid1,nid2,snr", [(6, 11, 2, 0.0),
                                                (6, 0, 1, -10.0),
                                                (25, 100, 0, -6.0)])
def test_cell_search_equals_reference(n_rb, nid1, nid2, snr):
    """pss_pos, nid2, nid1, half and nid_cell equal; the peak within 1e-5
    of its scale; the CFO estimate within 1e-4 subcarrier spacings."""
    cap, _ = _captures(n_rb, nid1, nid2, 8, snr, cfo=0.1, seed=n_rb)
    fp = FrameParms(n_rb=n_rb, n_id_cell=3 * nid1 + nid2)
    got = sync.CellSearch(fp).search(torch.from_numpy(cap))
    jcs = jsy.CellSearch(fp)
    want = jax.jit(jcs.search)(jnp.asarray(cap))
    for k in ("pss_pos", "nid2", "nid1", "half", "nid_cell"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert _rel(got["peak"].numpy(), want["peak"]) < 1e-5
    cfo = sync.estimate_cfo(torch.from_numpy(cap), got["pss_pos"],
                            got["nid2"], fp.n_fft).numpy()
    jcfo = jsy.estimate_cfo(jnp.asarray(cap), want["pss_pos"], want["nid2"],
                            fp.n_fft)
    assert np.abs(cfo - np.asarray(jcfo)).max() < 1e-4


def test_cell_search_wraps_a_negative_sss_start_as_the_reference():
    """A PSS found in the first symbol puts the SSS start before the
    capture: both sides read it from the capture's end."""
    fp = FrameParms(n_rb=6)
    cap = (RNG.standard_normal((4, 5 * fp.samples_per_tti + fp.n_fft))
           + 0j).astype(np.complex64)
    pos = torch.tensor([0, 3, 100, 140])
    nid2 = torch.tensor([0, 1, 2, 0])
    got = sync.CellSearch(fp).sss_detect(torch.from_numpy(cap), pos, nid2)
    want = jsy.CellSearch(fp).sss_detect(jnp.asarray(cap), jnp.asarray(pos),
                                         jnp.asarray(nid2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------- PBCH --

def test_mib_and_pbch_coding_equal_reference():
    for n_rb, sfn, dur, res in ((25, 8, 0, 0), (50, 444, 1, 2),
                                (100, 1023, 1, 3), (6, 0, 0, 1)):
        mib = pbch.pack_mib(n_rb, sfn, dur, res)
        np.testing.assert_array_equal(mib, jpb.pack_mib(n_rb, sfn, dur, res))
        assert pbch.unpack_mib(mib) == jpb.unpack_mib(mib)
        for n_ant in (1, 2, 4):
            np.testing.assert_array_equal(pbch.pbch_encode(mib, n_ant),
                                          jpb.pbch_encode(mib, n_ant))
        for nid in (0, 101, 503):
            for phase in range(4):
                np.testing.assert_array_equal(
                    pbch.pbch_frame_symbols(mib, nid, phase, 2),
                    jpb.pbch_frame_symbols(mib, nid, phase, 2))
    for n_rb, nid in ((6, 0), (25, 1), (100, 302)):
        m, j = pbch.make_pbch_map(n_rb, nid), jpb.make_pbch_map(n_rb, nid)
        for f in ("sym", "sc", "bins"):
            np.testing.assert_array_equal(getattr(m, f), getattr(j, f))


@pytest.mark.parametrize("n_ant", [1, 2])
def test_pbch_blind_decode_equals_reference(n_ant):
    """ok, MIB bits, frame phase and antenna count equal on LLRs from
    clean to undecodable, every frame phase."""
    nid = 101
    mib = pbch.pack_mib(25, sfn=8)
    rows = []
    for phase in range(4):
        s = pbch.pbch_frame_symbols(mib, nid, phase, n_ant=n_ant)
        llr = np.empty(480, np.float32)
        llr[0::2], llr[1::2] = s.real, s.imag
        rows.append(llr)
    llr = np.repeat(np.stack(rows), 8, axis=0)
    sigma = np.tile(np.linspace(0.05, 3.0, 8), 4)[:, None]
    llr = (4.0 * (llr + sigma * RNG.standard_normal(llr.shape))
           ).astype(np.float32)
    got = pbch.pbch_blind_decode(torch.from_numpy(llr), nid)
    want = jpb.pbch_blind_decode(jnp.asarray(llr), nid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ok = got[0].numpy()
    assert ok.any() and not ok.all()
    assert (got[2].numpy()[ok] == np.repeat(np.arange(4), 8)[ok]).all()
    assert (got[3].numpy()[ok] == n_ant).all()


B = 16
PBCH_CASES = {"6 PRB phase 2": (dict(n_rb=6, frame_phase=2),
                                [(-2.0, 0), (-9.0, 1)]),
              "25 PRB perfect CE": (dict(n_rb=25, n_id_cell=7,
                                         perfect_ce=True), [(-8.0, 2)])}


def _noise_replay(keys, n):
    return torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.normal(k, (n, 2)))(keys)))


@pytest.mark.parametrize("case", sorted(PBCH_CASES))
def test_pbchsim_decisions_equal_reference(case):
    cfg, points = PBCH_CASES[case]
    jsim = JPbchsim(JPbchConfig(batch=B, **cfg))
    sim = Pbchsim(PbchsimConfig(batch=B, **cfg), device="cpu")
    fails = []
    for snr, seed in points:
        n0 = np.float32(10.0 ** (-snr / 10.0))
        keys = jnp.asarray(host_keys(seed, B))
        want = np.asarray(jsim._jit(keys, jnp.float32(n0), jnp.asarray(
            j_wiener(jsim.gm, float(n0) / 4.0))))
        got = sim.trial(_noise_replay(keys, sim.tx.shape[1]), n0,
                        sim.wiener(snr)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{case} {snr}")
        fails.append(int((~got).sum()))
    if len(fails) > 1:
        assert fails[0] == 0, fails
    assert fails[-1] > 0, fails


# ---------------------------------------------------------------- Syncsim --

SYNC_CASES = {"6 PRB": (dict(n_rb=6, nid1=11, nid2=2), [(3.0, 0),
                                                         (-12.0, 1)]),
              "6 PRB CFO 0.2": (dict(n_rb=6, cfo_scs=0.2), [(10.0, 2)])}


def _sync_replay(keys, max_off, L):
    def one(key):
        koff, kn = jax.random.split(key)
        return (jax.random.randint(koff, (), 0, max_off),
                jax.random.normal(kn, (L, 2)))
    off, noise = jax.vmap(one)(keys)
    return torch.from_numpy(np.array(off)), torch.from_numpy(np.array(noise))


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_syncsim_equals_reference(case):
    """nid_ok and pos_err equal; the CFO estimates within 1e-4 subcarrier
    spacings where the PSS was found, and equal in sign elsewhere."""
    cfg, points = SYNC_CASES[case]
    jsim = JSyncsim(JSyncConfig(batch=B, **cfg))
    sim = Syncsim(SyncsimConfig(batch=B, **cfg), device="cpu")
    np.testing.assert_array_equal(sim.subframe_t.numpy(), jsim.subframe_t)
    assert (sim.pss_t0, sim.max_off) == (jsim.pss_t0, jsim.max_off)
    oks = []
    for snr, seed in points:
        n0 = np.float32(10.0 ** (-snr / 10.0))
        keys = jnp.asarray(host_keys(seed, B))
        want = [np.asarray(x) for x in jsim._step(keys, jnp.float32(n0))]
        got = [x.numpy() for x in sim.trial(
            *_sync_replay(keys, sim.max_off, sim.search.capture_len), n0)]
        np.testing.assert_array_equal(got[0], want[0], err_msg=case)
        np.testing.assert_array_equal(got[1], want[1], err_msg=case)
        found = got[1] == 0
        assert np.abs(got[2] - want[2])[found].max(initial=0) < 1e-4
        oks.append(int(got[0].sum()))
    assert oks[0] == B and (len(oks) == 1 or oks[-1] < B), oks
    if cfg.get("cfo_scs"):
        assert abs(np.abs(got[2]).mean() - cfg["cfo_scs"]) < 0.07


def test_carrier_scan_equals_reference():
    """The winning hypothesis, cell ID, half and timing equal; the fine
    CFO within 1e-4: captures at 0 and 1 subcarrier of offset."""
    cap, _ = _captures(6, 1, 2, 4, 0.0, seed=3)
    L = cap.shape[1]
    cap[2:] *= np.exp(2j * np.pi / 128 * np.arange(L)).astype(np.complex64)
    hyps = (-1.0, 0.0, 1.0)
    got = CarrierScan(ScanConfig(n_rb=6, freq_hyps=hyps),
                      device="cpu").scan(torch.from_numpy(cap))
    want = JCarrierScan(JScanConfig(n_rb=6, freq_hyps=hyps)).scan(
        jnp.asarray(cap))
    for k in ("nid1", "nid2", "pss_pos", "half", "hyp", "coarse_cfo"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert np.abs(got["fine_cfo"].numpy() - want["fine_cfo"]).max() < 1e-4
    np.testing.assert_array_equal(got["coarse_cfo"].numpy(), [0, 0, 1, 1])
    assert (got["nid1"].numpy() == 1).all() and (got["nid2"].numpy() == 2).all()


# ------------------------------------------ command lines and anchors --

def test_pbchsim_and_syncsim_command_lines_on_the_cpu(capsys):
    rows = pbchsim.main(["-B", "6", "-s", "-4", "-S", "-2", "-n", "1",
                         "--device", "cpu"])
    assert [r["snr_db"] for r in rows] == [-4.0, -2.0]
    assert all(r["trials"] == 64 for r in rows)
    rows = syncsim.main(["-B", "6", "-s", "3", "-S", "3", "-n", "1",
                         "--device", "cpu"])
    assert len(rows) == 1 and rows[0]["det_rate"] >= 0.9
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and "PBCH BLER" in out[0] and "det" in out[2]


def test_sync_pbch_operating_points_through_the_port():
    """tests/test_sync_pbch.py's link points (cell search at 3 dB, the CFO
    estimate at 10 dB, PBCH at -2 and -12 dB), with the port's draws."""
    r = Syncsim(SyncsimConfig(n_rb=6, nid1=11, nid2=2, batch=16),
                device="cpu").run_snr(3.0, n_batches=1)
    assert r["det_rate"] >= 0.9 and r["timing_err_rate"] <= 0.1
    r = Syncsim(SyncsimConfig(n_rb=6, batch=16, cfo_scs=0.2),
                device="cpu").run_snr(10.0, n_batches=1)
    assert abs(r["mean_abs_cfo"] - 0.2) < 0.07
    sim = Pbchsim(PbchsimConfig(n_rb=25, batch=32, frame_phase=2),
                  device="cpu")
    assert sim.run_snr(-2.0, n_batches=1)["bler"] <= 0.1
    assert sim.run_snr(-12.0, n_batches=1)["bler"] >= 0.9


@pytest.mark.slow
def test_pbch_anchors_through_the_port():
    """tests/test_pbch_pdcch_anchor.py's PBCH checks at 25 PRB, 512 trials
    a point: at least as good as pbch_awgn.txt's curve, and the waterfall
    pinned."""
    sim = Pbchsim(PbchsimConfig(batch=256), device="cpu")
    for snr, ref in ((-6.2, 0.499), (-4.2, 0.088), (-2.2, 0.0092)):
        assert sim.run_snr(snr, n_batches=2)["bler"] <= ref + 0.05, snr
    assert 0.28 <= sim.run_snr(-7.0, n_batches=2)["bler"] <= 0.58
    assert sim.run_snr(-5.0, n_batches=2)["bler"] <= 0.10
