"""The control channels of the PyTorch port against the JAX reference on
the same inputs: the CFI decoder, the format-1A size and fields, the
exhaustive search space, DCI formats 0, 1C, 3 and 3A, the PHICH, the
pilot extraction, and Pdcchsim on the reference's replayed draws (per
trial the noise normals from the trial's key), plus the pdcchsim command
line with --device cpu.

Decisions (CFI, DCI flags, payload fields, ACK signs) must be equal; soft
values are held within the float32 tolerance stated at each check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.phy import dci_formats as jdf
from openair4g_tpu.phy.channel_est import make_wiener_stack as j_wiener
from openair4g_tpu.phy import pdcch as jpd
from openair4g_tpu.phy import phich as jph
from openair4g_tpu.phy import resource_grid as jrg
from openair4g_tpu.sim.pdcchsim import Pdcchsim as JPdcchsim
from openair4g_tpu.sim.pdcchsim import PdcchsimConfig as JConfig
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.phy import dci_formats as df
from openair4g_tpu_torch.phy import pdcch as pd
from openair4g_tpu_torch.phy import phich as ph
from openair4g_tpu_torch.phy import resource_grid as rg
from openair4g_tpu_torch.sim.pdcchsim import Pdcchsim, PdcchsimConfig, main

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

RNG = np.random.default_rng(41)
N_RBS = (6, 15, 25, 50, 75, 100)


def _cplx(*shape):
    return (RNG.standard_normal(shape)
            + 1j * RNG.standard_normal(shape)).astype(np.complex64)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# ------------------------------------------------------------------ PCFICH --

def test_cfi_decode_equals_reference():
    """The decisions equal, the correlations within 1e-6 of their scale;
    the LLRs run from clean codewords to noise."""
    cfi = RNG.integers(1, 4, 256)
    code = np.stack([pd.cfi_encode(int(c)) for c in cfi])
    sigma = np.linspace(0.1, 6.0, 256)[:, None]
    llr = ((1.0 - 2.0 * code) + sigma * RNG.standard_normal(code.shape)
           ).astype(np.float32)
    got, corr = pd.cfi_decode(torch.from_numpy(llr))
    want, jcorr = jpd.cfi_decode(jnp.asarray(llr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _rel(corr.numpy(), jcorr) < 1e-6
    assert (got.numpy()[:32] == cfi[:32]).all() and (got.numpy() != cfi).any()


# ------------------------------------------------------------ DCI formats --

@pytest.mark.parametrize("tdd", [False, True])
def test_format1a_size_pack_unpack_equal_reference(tdd):
    for n_rb in N_RBS:
        assert pd.dci_format1a_size(n_rb, tdd) == \
            jpd.dci_format1a_size(n_rb, tdd)
        for rb_start, n_prb in ((0, n_rb), (1, 2), (n_rb // 2, n_rb // 2)):
            args = (n_rb, rb_start, n_prb, 13, 5, 1, 2, 3)
            bits = pd.pack_dci_format1a(*args, tdd=tdd, dai=2)
            np.testing.assert_array_equal(
                bits, jpd.pack_dci_format1a(*args, tdd=tdd, dai=2))
            assert len(bits) == pd.dci_format1a_size(n_rb, tdd)
            got = pd.unpack_dci_format1a(bits, n_rb, tdd)
            assert got == jpd.unpack_dci_format1a(bits, n_rb, tdd)
            assert (got["rb_start"], got["n_prb"]) == (rb_start, n_prb)


@pytest.mark.parametrize("n_cce", [1, 4, 21, 55, 87])
def test_search_space_candidates_equal_reference(n_cce):
    as_pairs = lambda cs: [(c.L, c.cce_offset) for c in cs]   # noqa: E731
    got = as_pairs(pd.search_space_candidates(n_cce))
    assert got == as_pairs(jpd.search_space_candidates(n_cce))
    assert len(set(got)) == len(got)


@pytest.mark.parametrize("tdd", [False, True])
def test_format0_equals_reference(tdd):
    for n_rb in N_RBS:
        assert df.dci_format0_size(n_rb, tdd) == \
            jdf.dci_format0_size(n_rb, tdd)
        for args in ((n_rb, 0, n_rb, 28, 1, 3, 7, 1, 1),
                     (n_rb, 2, 3, 5, 0, 1, 2, 0, 0)):
            bits = df.pack_dci_format0(*args, tdd=tdd, ul_index=3)
            np.testing.assert_array_equal(
                bits, jdf.pack_dci_format0(*args, tdd=tdd, ul_index=3))
            got = df.unpack_dci_format0(bits, n_rb, tdd)
            assert got == jdf.unpack_dci_format0(bits, n_rb, tdd)
            assert got["is_format0"] and got["n_prb"] == args[2]


@pytest.mark.parametrize("n_rb", [6, 25, 50, 100])
def test_format1c_equals_reference(n_rb):
    assert df.dci_format1c_size(n_rb) == jdf.dci_format1c_size(n_rb)
    step = {6: 2, 25: 2, 50: 4, 100: 4}[n_rb]
    for rb_start, n_prb in ((0, step), (step, 2 * step), (0, 3 * step)):
        bits = df.pack_dci_format1c(n_rb, rb_start, n_prb, 9, ngap=1)
        np.testing.assert_array_equal(
            bits, jdf.pack_dci_format1c(n_rb, rb_start, n_prb, 9, ngap=1))
        assert df.unpack_dci_format1c(bits, n_rb) == \
            jdf.unpack_dci_format1c(bits, n_rb)
    with pytest.raises(ValueError):
        df.pack_dci_format1c(n_rb, 1, step, 0)


@pytest.mark.parametrize("n_rb", [6, 25, 100])
def test_formats3_3a_equal_reference(n_rb):
    assert df.dci_format3_n_cmds(n_rb) == jdf.dci_format3_n_cmds(n_rb)
    assert df.dci_format3a_n_cmds(n_rb) == jdf.dci_format3a_n_cmds(n_rb)
    cmds = RNG.integers(0, 4, df.dci_format3_n_cmds(n_rb) - 1).tolist()
    bits = df.pack_dci_format3(n_rb, cmds)
    np.testing.assert_array_equal(bits, jdf.pack_dci_format3(n_rb, cmds))
    assert len(bits) == df.dci_format0_size(n_rb)
    assert df.unpack_dci_format3(bits, n_rb) == \
        jdf.unpack_dci_format3(bits, n_rb)
    cmds = RNG.integers(0, 2, df.dci_format3a_n_cmds(n_rb)).tolist()
    bits = df.pack_dci_format3a(n_rb, cmds)
    np.testing.assert_array_equal(bits, jdf.pack_dci_format3a(n_rb, cmds))
    assert df.unpack_dci_format3a(bits, n_rb)["tpc_cmds"] == tuple(cmds)


def test_extract_pilot_res_equals_reference():
    gm, jgm = rg.make_grid_map(25, 2, 7, 3), jrg.make_grid_map(25, 2, 7, 3)
    grid = _cplx(3, 14, 512)
    np.testing.assert_array_equal(
        rg.extract_pilot_res(torch.from_numpy(grid), gm).numpy(),
        np.asarray(jrg.extract_pilot_res(jnp.asarray(grid), jgm)))


# ------------------------------------------------------------------ PHICH --

@pytest.mark.parametrize("nid,ns", [(0, 0), (7, 4), (301, 19)])
def test_phich_equals_reference(nid, ns):
    """TX chips equal; the despread statistics within 1e-6 of their scale
    and their ACK/NACK signs equal, on clean and on noisy groups."""
    np.testing.assert_array_equal(ph.phich_scramble(nid, ns),
                                  jph.phich_scramble(nid, ns))
    acks = RNG.integers(-1, 2, (16, 8))
    tx = np.stack([ph.phich_group_tx(a, nid, ns) for a in acks])
    np.testing.assert_array_equal(
        tx, np.stack([jph.phich_group_tx(a, nid, ns) for a in acks]))
    rx = (tx * np.sqrt(2) + 0.4 * _cplx(16, 12)).astype(np.complex64)
    got = ph.phich_group_rx(torch.from_numpy(rx), nid, ns).numpy()
    want = np.asarray(jph.phich_group_rx(jnp.asarray(rx), nid, ns))
    assert _rel(got, want) < 1e-6
    np.testing.assert_array_equal(np.sign(got.real), np.sign(want.real))
    on = acks >= 0
    assert ((got.real > 0) == (acks == 1))[on].mean() > 0.9


@pytest.mark.parametrize("n_rb,nid,n_group", [(25, 7, 3), (6, 0, 1),
                                              (100, 44, 4)])
def test_phich_reg_positions_equal_reference(n_rb, nid, n_group):
    np.testing.assert_array_equal(ph.phich_reg_positions(n_rb, nid, n_group),
                                  jph.phich_reg_positions(n_rb, nid, n_group))


# --------------------------------------------------------------- Pdcchsim --

B = 32
# (config, [(SNR, seed)]): a point where every DCI decodes and one where
# some CFI and DCI decisions fail
CASES = {"6 PRB L=4": (dict(n_rb=6, n_pdcch=3, L=4), [(2.0, 0), (-9.0, 1)]),
         "25 PRB L=2 CCE 4": (dict(n_rb=25, n_pdcch=2, L=2, cce_offset=4),
                              [(-6.0, 2)])}


def replay(keys, n_samples):
    """The reference step's noise normals: [T, 2] from each trial's key."""
    return torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.normal(k, (n_samples, 2)))(keys)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pdcchsim_decisions_equal_reference(case):
    cfg, points = CASES[case]
    jsim = JPdcchsim(JConfig(batch=B, **cfg))
    sim = Pdcchsim(PdcchsimConfig(batch=B, **cfg), device="cpu")
    np.testing.assert_array_equal(sim.dci_payload, jsim.dci_payload)
    assert [(c.L, c.cce_offset) for c in sim.candidates] == \
        [(c.L, c.cce_offset) for c in jsim.candidates]
    fails = []
    for snr, seed in points:
        n0 = np.float32(10.0 ** (-snr / 10.0))
        keys = jnp.asarray(host_keys(seed, B))
        wiener = jnp.asarray(j_wiener(jsim.gm, float(n0) / 4.0))
        c_want, d_want = (np.asarray(x) for x in
                          jsim._jit(keys, jnp.float32(n0), wiener))
        c_got, d_got = sim.trial(replay(keys, sim.tx.shape[1]), n0,
                                 sim.wiener(snr))
        np.testing.assert_array_equal(c_got.numpy(), c_want, err_msg=case)
        np.testing.assert_array_equal(d_got.numpy(), d_want, err_msg=case)
        fails.append(int((~d_got).sum()) + int((~c_got).sum()))
    if len(fails) > 1:
        assert fails[0] == 0, fails
    assert fails[-1] > 0, fails


def test_pdcchsim_command_line_on_the_cpu(capsys):
    rows = main(["-B", "6", "-s", "-4", "-S", "0", "--step", "4", "-n", "1",
                 "--device", "cpu"])
    assert [r["snr_db"] for r in rows] == [-4.0, 0.0]
    assert all(r["trials"] == 64 for r in rows)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all("DCI err" in line for line in out)
