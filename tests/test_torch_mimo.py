"""Modules of the multi-antenna downlink in the PyTorch port against the JAX
reference on the same numpy inputs.

Tolerances: SFBC, precoding, MMSE and dual-stream detection, the port
grids, the per-port Wiener matrices and channel estimates 1e-5 (complex64
sums in another order); DCI payloads bit-exact; the MIMO tap draw from the
same normals 1e-6; the max-log demap rtol = atol = 3e-4 against the Pallas
kernel (as tests/test_equalize_llr.py); the v1 turbo half-iteration 1e-4
against its Pallas kernel in interpret mode (same float32 operations).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.ops.equalize_llr import demap_llr_fused as j_demap_fused
from openair4g_tpu.ops.equalize_llr import mrc_llr_pallas
from openair4g_tpu.ops.turbo_pallas import half_iteration_pallas
from openair4g_tpu.phy import alamouti as ja
from openair4g_tpu.phy import channel_est as jce
from openair4g_tpu.phy import dci_formats as jdf
from openair4g_tpu.phy import mimo_rx as jmr
from openair4g_tpu.phy import precoding as jpc
from openair4g_tpu.phy import resource_grid as jrg
from openair4g_tpu.config import FrameParms as JFrameParms
from openair4g_tpu.sim.channels import ChannelModel as JChannelModel
from openair4g_tpu.utils.rng import host_keys
from openair4g_tpu_torch.config import FrameParms
from openair4g_tpu_torch.convert import wiener_stack_from_reference
from openair4g_tpu_torch.device import launch_counts
from openair4g_tpu_torch.ops.equalize_llr import (_one_stride,
                                                  demap_llr_fused,
                                                  demap_llr_fused_ref)
from openair4g_tpu_torch.ops.turbo_cuda import (BIG, half_iteration_prepped,
                                                half_iteration_prepped_ref,
                                                half_iteration_ref,
                                                prep_parity)
from openair4g_tpu_torch.phy import alamouti, channel_est, dci_formats
from openair4g_tpu_torch.phy import mimo_rx, precoding, resource_grid
from openair4g_tpu_torch.sim.channels import ChannelModel

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------- alamouti --

def test_sfbc_encode_and_combine_match_reference():
    rng = np.random.default_rng(0)
    B, R, N = 3, 2, 64
    x = _cplx(rng, B, N)
    for got, want in zip(alamouti.sfbc_encode(_t(x)),
                         ja.sfbc_encode(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    y, h0, h1 = (_cplx(rng, B, R, N) for _ in range(3))
    got = alamouti.sfbc_combine(_t(y), _t(h0), _t(h1), 0.03)
    want = ja.sfbc_combine(jnp.asarray(y), jnp.asarray(h0), jnp.asarray(h1),
                           jnp.float32(0.03))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_sfbc_round_trip_recovers_symbols():
    rng = np.random.default_rng(1)
    B, R, N = 2, 2, 16
    x = _cplx(rng, B, N)
    p0, p1 = alamouti.sfbc_encode(_t(x))
    h = _cplx(rng, B, 2, R)
    y = _t(h[:, 0, :, None]) * p0[:, None] + _t(h[:, 1, :, None]) * p1[:, None]
    h0 = _t(np.broadcast_to(h[:, 0, :, None], (B, R, N)))
    h1 = _t(np.broadcast_to(h[:, 1, :, None], (B, R, N)))
    x_hat, n0_eff = alamouti.sfbc_combine(y, h0, h1, 0.1)
    np.testing.assert_allclose(x_hat.numpy(), x, atol=1e-5)
    assert n0_eff.shape == (B, N) and bool((n0_eff > 0).all())


# ------------------------------------------------------------ precoding --

def test_precoders_equal_reference():
    for rank in (1, 2):
        np.testing.assert_array_equal(precoding.codebook_2tx(rank),
                                      jpc.codebook_2tx(rank))
    np.testing.assert_array_equal(precoding.cdd_precoders_2tx(10),
                                  jpc.cdd_precoders_2tx(10))


@pytest.mark.parametrize("which", ["cdd", "rank2", "rank1"])
def test_precode_and_effective_channel_match_reference(which):
    rng = np.random.default_rng(2)
    B, N, R = 2, 12, 2
    W = {"cdd": jpc.cdd_precoders_2tx(N), "rank2": jpc.codebook_2tx(2)[1],
         "rank1": jpc.codebook_2tx(1)[2] / np.sqrt(2)}[which]
    L = W.shape[-1]
    cws = [_cplx(rng, B, N) for _ in range(L)]
    s = precoding.layer_map([_t(c) for c in cws])
    js = jpc.layer_map([jnp.asarray(c) for c in cws])
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(precoding.precode(s, W).numpy(),
                               np.asarray(jpc.precode(js, W)), **TOL)
    H = _cplx(rng, B, R, N, 2)
    He = precoding.effective_channel(_t(H), W)
    assert He.dtype == torch.complex64
    np.testing.assert_allclose(
        He.numpy(), np.asarray(jpc.effective_channel(jnp.asarray(H), W)),
        **TOL)


# -------------------------------------------------------------- mimo_rx --

def test_mmse_detect_and_matched_filter_match_reference():
    rng = np.random.default_rng(3)
    B, N, R = 2, 40, 2
    y, He = _cplx(rng, B, N, R), _cplx(rng, B, N, R, 2)
    for got, want in zip(mimo_rx.mmse_detect(_t(y), _t(He), 0.3),
                         jmr.mmse_detect(jnp.asarray(y), jnp.asarray(He),
                                         jnp.float32(0.3))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = mimo_rx.mf_dual_stream(_t(y), _t(He))
    want = jmr.mf_dual_stream(jnp.asarray(y), jnp.asarray(He))
    for g3, w3 in zip(got, want):
        for g, w in zip(g3, w3):
            np.testing.assert_allclose(g.resolve_conj().numpy(),
                                       np.asarray(w), **TOL)


@pytest.mark.parametrize("qm0", [2, 4, 6])
def test_dual_stream_llr_matches_reference(qm0):
    """Chunk 16 over N = 40: the ragged last chunk is covered too."""
    rng = np.random.default_rng(qm0)
    B, N = 2, 40
    z0, rho = _cplx(rng, B, N), _cplx(rng, B, N) * 0.3
    g0 = rng.uniform(0.5, 2.0, (B, N)).astype(np.float32)
    s0, s1, bit0 = mimo_rx._joint_tables(qm0, 2)
    js0, js1, jbit0 = jmr._joint_tables(qm0, 2)
    np.testing.assert_array_equal(s0, js0)
    np.testing.assert_array_equal(s1, js1)
    np.testing.assert_array_equal(bit0, jbit0)
    got = mimo_rx.dual_stream_llr(_t(z0), _t(rho), _t(g0), 0.2, qm0, 2,
                                  chunk=16)
    want = jmr.dual_stream_llr(jnp.asarray(z0), jnp.asarray(rho),
                               jnp.asarray(g0), jnp.float32(0.2), qm0, 2)
    assert got.shape == (B, N, qm0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------- port grids --

@pytest.mark.parametrize("port", [0, 1])
def test_fill_grid_port_matches_reference(port):
    gm, jgm = resource_grid.make_grid_map(25, 1, 0, 7, nports=2), \
        jrg.make_grid_map(25, 1, 0, 7, nports=2)
    for f in ("data_sym", "data_sc", "data_bin", "pilot_sym", "pilot_bin",
              "pilot_val", "pilot_port"):
        np.testing.assert_array_equal(getattr(gm, f), getattr(jgm, f))
    x = _cplx(np.random.default_rng(4), 2, gm.n_data_re)
    got = resource_grid.fill_grid_port(_t(x), gm, port).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jrg.fill_grid_port(jnp.asarray(x), jgm, port)))
    other = gm.pilot_port != port
    assert (got[:, gm.pilot_sym[other], gm.pilot_bin[other]] == 0).all()


# ----------------------------------------------------------- DCI formats --

_DCI_CASES = {
    "1": lambda m, n: m.pack_dci_format1(n, 5, 13, 2, 1, 3, tpc=1),
    "2a": lambda m, n: m.pack_dci_format2a(n, 3, 4, 1, 13, 1, 2, 20, 0, 1,
                                           tpc=2),
    "2": lambda m, n: m.pack_dci_format2(n, 3, 4, 1, 13, 1, 2, 20, 0, 1,
                                         precoding=2),
    "1b": lambda m, n: m.pack_dci_format1b(n, 1, n - 2, 9, 5, 1, 2, 3, 1),
    "1d": lambda m, n: m.pack_dci_format1d(n, 0, n // 2, 9, 5, 1, 2, 2, 1),
}


@pytest.mark.parametrize("fmt", sorted(_DCI_CASES))
@pytest.mark.parametrize("n_rb", [6, 25, 50, 100])
def test_dci_payloads_bit_exact_and_round_trip(fmt, n_rb):
    got = _DCI_CASES[fmt](dci_formats, n_rb)
    want = _DCI_CASES[fmt](jdf, n_rb)
    np.testing.assert_array_equal(got, want)
    size = getattr(dci_formats, f"dci_format{fmt}_size")(n_rb)
    assert len(got) == size == getattr(jdf, f"dci_format{fmt}_size")(n_rb)
    unpack = getattr(dci_formats, f"unpack_dci_format{fmt}")
    assert unpack(got, n_rb) == getattr(jdf, f"unpack_dci_format{fmt}")(
        want, n_rb)
    assert dci_formats.n_rbg(n_rb) == jdf.n_rbg(n_rb)


def test_dci_fields_read_back():
    f2a = dci_formats.unpack_dci_format2a(
        dci_formats.pack_dci_format2a(50, 7, 4, 1, 13, 1, 2, 20, 0, 1), 50)
    assert (f2a["rbg_bitmap"], f2a["mcs1"], f2a["mcs2"], f2a["rv2"]) == \
        (7, 13, 20, 1)
    f1d = dci_formats.unpack_dci_format1d(
        dci_formats.pack_dci_format1d(25, 3, 20, 9, 5, 1, 2, 2, 1), 25)
    assert (f1d["rb_start"], f1d["n_prb"], f1d["tpmi"],
            f1d["dl_power_off"]) == (3, 20, 2, 1)
    with pytest.raises(ValueError):
        dci_formats.pack_dci_format1(25, 1 << 13, 4, 0, 1, 0)


# --------------------------------------------------- per-port estimation --

@pytest.mark.parametrize("port", [0, 1])
def test_wiener_stack_equals_reference(port):
    gm, jgm = resource_grid.make_grid_map(25, 1, nports=2), \
        jrg.make_grid_map(25, 1, nports=2)
    np.testing.assert_allclose(channel_est.make_wiener_stack(gm, 0.02, port),
                               jce.make_wiener_stack(jgm, 0.02, port), **TOL)
    np.testing.assert_array_equal(channel_est._time_interp_weights(25),
                                  jce._time_interp_weights(25))


@pytest.mark.parametrize("time_avg", [True, False])
@pytest.mark.parametrize("port", [0, 1])
def test_estimate_channel_matches_reference(port, time_avg):
    gm, jgm = resource_grid.make_grid_map(25, 1, nports=2), \
        jrg.make_grid_map(25, 1, nports=2)
    rg = _cplx(np.random.default_rng(5 + port), 3, 14, gm.fp.n_fft)
    packed = jce.make_wiener_stack(jgm, 0.01, port)
    W = wiener_stack_from_reference(packed, "cpu")
    assert W.dtype == torch.complex64 and W.shape == packed.shape[:-1]
    got = channel_est.estimate_channel(_t(rg), gm, W, time_avg, port)
    want = jce.estimate_channel(jnp.asarray(rg), jgm, jnp.asarray(packed),
                                time_avg, port)
    assert got.shape == (3, 14, gm.fp.n_sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------- channels --

@pytest.mark.parametrize("name,n_rx", [("EVA", 2), ("EPA", 1), ("ETU", 2),
                                       ("Rayleigh1", 2)])
def test_mimo_tap_draw_matches_reference(name, n_rx):
    B = 3
    jcm = JChannelModel(name=name, fp=JFrameParms(n_rb=25), n_tx=2,
                        n_rx=n_rx)
    cm = ChannelModel(name=name, fp=FrameParms(n_rb=25), n_tx=2, n_rx=n_rx)
    keys = jnp.asarray(host_keys(3, B))
    normals = jax.vmap(lambda k: jax.random.normal(
        k, (n_rx, 2, jcm.n_taps, 2)))(keys)
    want = jcm.draw_taps(keys, B)
    got = cm.draw_taps(B, normals=_t(np.asarray(normals)))
    assert got.shape == (B, n_rx, 2, cm.n_taps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(cm.freq_response(got).numpy(),
                               np.asarray(jcm.freq_response(want)), **TOL)


@pytest.mark.parametrize("name", ["Rice1", "Rayleigh1_corr", "SCM_C",
                                  "Rayleigh8", "AWGN"])
def test_catalog_channels_draw_2x2_taps(name):
    """Every catalog model draws [B, 2, 2, T] taps for the 2x2 simulators
    (its draw is held to the reference in test_torch_channels.py)."""
    cm = ChannelModel(name=name, fp=FrameParms(n_rb=25), n_tx=2, n_rx=2)
    taps = cm.draw_taps(3, generator=torch.Generator().manual_seed(0))
    assert taps.shape == (3, 2, 2, cm.n_taps)
    assert cm.freq_response(taps).shape == (3, 2, 2, 300)


# -------------------------------------------------------- demap_llr_fused --

@pytest.mark.parametrize("Qm", [2, 4, 6])
def test_demap_llr_fused_matches_reference_and_pallas(Qm):
    """x_hat and n0_eff as one layer of an MMSE output [B, N, 2] (strided
    views), as in the TM3/4 receivers."""
    rng = np.random.default_rng(10 + Qm)
    xs = _cplx(rng, 2, 300, 2)
    n0s = rng.uniform(0.05, 2.0, (2, 300, 2)).astype(np.float32)
    x, n0 = _t(xs)[..., 1], _t(n0s)[..., 1]
    assert not x.is_contiguous() \
        and _one_stride(x.shape, x.stride()) == 2
    got = demap_llr_fused(x, n0, Qm)
    assert torch.equal(got, demap_llr_fused_ref(x, n0, Qm))
    xj, n0j = jnp.asarray(xs[..., 1]), jnp.asarray(n0s[..., 1])
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_demap_fused(xj, n0j, Qm)),
                               rtol=3e-4, atol=3e-4)
    pallas = mrc_llr_pallas(xj[..., None], jnp.ones(xj.shape + (1,),
                                                    jnp.complex64),
                            n0j, Qm, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=3e-4,
                               atol=3e-4)


def test_element_stride_and_demap_device_rule():
    def one(t):
        return _one_stride(t.shape, t.stride())
    t = torch.zeros(4, 6, 2)
    assert one(t) == 1
    assert one(t[..., 0]) == 2
    assert one(t[:, :3, 0]) is None
    assert one(t.transpose(0, 1)) is None
    # a broadcast view walks at stride 0, one value a row at no one stride
    # (the kernel then takes it as rows x cols)
    assert one(torch.zeros(()).expand(4, 6)) == 0
    assert one(torch.zeros(6).expand(4, 6)) is None
    assert one(torch.zeros(4, 1, 1)) == 1 and one(torch.zeros(1, 1)) == 0
    x = torch.zeros(2, 8, dtype=torch.complex64)
    before = launch_counts()["demap_llr"]
    demap_llr_fused(x, 0.5, 2)
    assert launch_counts()["demap_llr"] == before
    with pytest.raises(ValueError):
        demap_llr_fused(x.to("meta"), 0.5, 2)


def test_demap_llr_fused_takes_broadcast_n0():
    """n0_eff as a full-shape view of one value, or of one value per row,
    gives the LLRs of the materialized n0_eff."""
    rng = np.random.default_rng(3)
    x = _t(_cplx(rng, 3, 40))
    for n0 in (torch.tensor(0.3).expand_as(x.real),
               torch.tensor([0.2, 0.5, 1.1])[:, None].expand(3, 40)):
        want = demap_llr_fused_ref(x, n0.contiguous(), 4)
        assert torch.equal(demap_llr_fused(x, n0, 4), want)


# ---------------------------------------------------------- turbo v1 --

def _turbo_inputs(B, W, n_w, seed):
    rng = np.random.default_rng(seed)
    N = W * n_w
    lin = (3.0 * rng.standard_normal((B, N))).astype(np.float32)
    lp = (3.0 * rng.standard_normal((B, N))).astype(np.float32)
    lin[:, -7:] = BIG
    lp[:, -7:] = BIG
    return lin, lp


@pytest.mark.parametrize("B,W,n_w", [(2, 48, 2), (2, 48, 3), (3, 96, 3)])
def test_v1_plain_version_matches_pallas_v1(B, W, n_w):
    U = 24
    lin, lp = _turbo_inputs(B, W, n_w, seed=W + n_w)
    want = np.asarray(half_iteration_pallas(jnp.asarray(lin), jnp.asarray(lp),
                                            W, U, interpret=True))
    gpf, gpb = prep_parity(_t(lp), W, U)
    assert gpf.shape == (W + U, B * n_w)
    got = half_iteration_prepped_ref(_t(lin), gpf, gpb, W, U).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # v1 and v2 differ only by rounding at window-end nodes
    v2 = half_iteration_ref(_t(lin), _t(lp), W, U).numpy()
    interior = np.ones(W * n_w, bool)
    interior[np.arange(W - 1, W * n_w, W)] = False
    np.testing.assert_allclose(got[:, interior], v2[:, interior], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got, v2, rtol=1e-3, atol=0.05)


def test_v1_wrapper_device_rule_and_shapes():
    lin, lp = _turbo_inputs(2, 48, 2, seed=0)
    gpf, gpb = prep_parity(_t(lp), 48, 24)
    before = launch_counts()["turbo_half_iter_v1"]
    assert torch.equal(half_iteration_prepped(_t(lin), gpf, gpb, 48, 24),
                       half_iteration_prepped_ref(_t(lin), gpf, gpb, 48, 24))
    assert launch_counts()["turbo_half_iter_v1"] == before
    with pytest.raises(ValueError):
        half_iteration_prepped(_t(lin), gpf[:-1], gpb, 48, 24)
    meta = torch.zeros(2, 96, device="meta")
    with pytest.raises(ValueError):
        half_iteration_prepped(meta, gpf.to("meta"), gpb.to("meta"), 48, 24)
