"""The uplink modules of the PyTorch port against the JAX reference on the
same numpy inputs: the Gold c_init, the batched convolutional encoder and
CC rate matching, the DMRS tables and Zadoff-Chu sequences, the hopping
patterns, the PUSCH maps and the UCI plan (numpy copies: held equal), the
SC-FDMA transforms, grid fill and extraction, the uplink estimator and
equalizer, the UCI coders and decisions, and the channel at explicit
subcarriers.

Integer results and numpy copies must be equal. Soft values are held to
float32 tolerances relative to their scale, stated at each check: the DFT
and Wiener matmuls and the mean over M sum in another order than XLA's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.ops import convcode as j_cc
from openair4g_tpu.ops import gold as j_gold
from openair4g_tpu.ops import rate_match as j_rm
from openair4g_tpu.ops import uci as j_uci
from openair4g_tpu.phy import hopping as j_hop
from openair4g_tpu.phy import pusch as j_pusch
from openair4g_tpu.phy import scfdma as j_sc
from openair4g_tpu.phy import ulref as j_ulref
from openair4g_tpu.sim import channels as j_ch
from openair4g_tpu.config import FrameParms as JFrameParms
from openair4g_tpu.tables import _ul_dmrs_phi as j_phi
from openair4g_tpu_torch.config import FrameParms
from openair4g_tpu_torch.ops import convcode, gold, rate_match, uci
from openair4g_tpu_torch.phy import hopping, pusch, scfdma, ulref
from openair4g_tpu_torch.sim import channels
from openair4g_tpu_torch.tables import _ul_dmrs_phi

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

RNG = np.random.default_rng(20)


def _cplx(*shape):
    return (RNG.standard_normal(shape)
            + 1j * RNG.standard_normal(shape)).astype(np.complex64)


def _rel(got, want):
    """max |got - want| over the scale max |want|."""
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _eq_fields(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "fp":
            assert (x.n_rb, x.normal_cp) == (y.n_rb, y.normal_cp)
        elif isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name
        else:
            assert x == y, f.name


# ------------------------------------------------------------ bit level --

@pytest.mark.parametrize("rnti,ns,nid", [(0x1234, 0, 0), (65535, 19, 503),
                                         (61, 8, 17)])
def test_pusch_cinit_equals_reference(rnti, ns, nid):
    assert gold.pusch_cinit(rnti, ns, nid) == j_gold.pusch_cinit(rnti, ns,
                                                                  nid)


@pytest.mark.parametrize("K", [20, 38, 64])
def test_conv_encode_device_equals_reference(K):
    bits = RNG.integers(0, 2, (5, K)).astype(np.int32)
    got = convcode.conv_encode_device(torch.from_numpy(bits)).numpy()
    want = np.asarray(j_cc.conv_encode_device(jnp.asarray(bits)))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    for b, row in zip(bits, got):
        np.testing.assert_array_equal(row, j_cc.conv_encode_host(b))


@pytest.mark.parametrize("D,E", [(28, 96), (38, 192), (46, 1000)])
def test_cc_rate_match_tx_equals_reference(D, E):
    ours = rate_match.make_cc_rate_match_maps(D, E)
    ref = j_rm.make_cc_rate_match_maps(D, E)
    np.testing.assert_array_equal(ours.e_src, ref.e_src)
    np.testing.assert_array_equal(ours.d_from_order, ref.d_from_order)
    d = RNG.integers(0, 2, (3, 3 * D)).astype(np.int32)
    np.testing.assert_array_equal(
        rate_match.cc_rate_match_tx(torch.from_numpy(d), ours).numpy(),
        np.asarray(j_rm.cc_rate_match_tx(jnp.asarray(d), ref)))


# ------------------------------------------------------- sequences, maps --

def test_dmrs_phi_tables_are_the_reference_copy():
    assert _ul_dmrs_phi.PHI_12 == j_phi.PHI_12
    assert _ul_dmrs_phi.PHI_24 == j_phi.PHI_24


def test_zadoff_chu_and_dmrs_equal_reference():
    assert ulref.DFT_SIZES == j_ulref.DFT_SIZES
    for m in ulref.DFT_SIZES:
        for u in (0, 7, 29):
            for v in ((0, 1) if m >= 72 else (0,)):
                np.testing.assert_array_equal(
                    ulref.zc_base_sequence(u, v, m),
                    j_ulref.zc_base_sequence(u, v, m))
        np.testing.assert_array_equal(
            ulref.pusch_dmrs(m, u=3, cyclic_shift=5),
            j_ulref.pusch_dmrs(m, u=3, cyclic_shift=5))
    with pytest.raises(ValueError):
        ulref.zc_base_sequence(0, 0, 132)


@pytest.mark.parametrize("nid", [0, 77, 301, 503])
def test_hopping_patterns_equal_reference(nid):
    np.testing.assert_array_equal(hopping.group_hop_pattern(nid),
                                  j_hop.group_hop_pattern(nid))
    np.testing.assert_array_equal(
        hopping.sequence_hop_pattern(nid, 2, True),
        j_hop.sequence_hop_pattern(nid, 2, True))
    np.testing.assert_array_equal(hopping.dmrs_cs_hop_pattern(nid),
                                  j_hop.dmrs_cs_hop_pattern(nid))
    for sf in (0, 3, 9):
        for gh, sh in ((True, False), (False, True), (False, False)):
            np.testing.assert_array_equal(
                hopping.pusch_dmrs_slots(144, nid, sf, 2, 4, gh, sh),
                j_hop.pusch_dmrs_slots(144, nid, sf, 2, 4, gh, sh))
    for n_sb in (1, 2, 3, 4):
        assert hopping.pusch_hop_pattern(nid, n_sb) == \
            j_hop.pusch_hop_pattern(nid, n_sb)


def test_pusch_hopped_rb_start_equals_reference():
    cases = 0
    for n_rb_ul in (25, 50, 100):
        for n_sb, n_rb_ho in ((1, 0), (2, 1), (4, 2), (3, 4)):
            first, n_rb_sb, n_use = hopping.pusch_hopping_region(
                n_rb_ul, n_sb, n_rb_ho)
            assert (first, n_rb_sb, n_use) == j_hop.pusch_hopping_region(
                n_rb_ul, n_sb, n_rb_ho)
            nbits = 1 if n_rb_ul < 50 else 2
            n_prb = max(1, min(4, n_rb_sb // 2))
            for bits in range(1 << nbits):
                for start in (first, first + 1):
                    for hop in range(5):
                        args = (start, n_prb, n_rb_ul, hop, bits, 7, n_sb,
                                n_rb_ho)
                        assert hopping.pusch_hopped_rb_start(*args) == \
                            j_hop.pusch_hopped_rb_start(*args), args
                        cases += 1
    assert cases == 400
    with pytest.raises(ValueError):
        hopping.pusch_hopped_rb_start(23, 4, 25, 1, 0)


@pytest.mark.parametrize("args", [
    (6, 6, 0), (25, 25, 0), (25, 6, 2, True, False, 14),
    (25, 4, 3, True, True, None), (100, 100, 0), (50, 12, 7, False)],
    ids=["6", "25", "25 hopped", "25 srs", "100", "50 extended CP"])
def test_make_pusch_map_equals_reference(args):
    ours, ref = scfdma.make_pusch_map(*args), j_sc.make_pusch_map(*args)
    _eq_fields(ours, ref)
    assert ours.hopped == ref.hopped
    inv = np.empty_like(ref.interleave)
    inv[ref.interleave] = np.arange(len(ref.interleave), dtype=np.int32)
    np.testing.assert_array_equal(ours.deinterleave, inv)


# (m_sc, n_data_sym, Qm, TBS-derived sum Kr, o_cqi, o_ri, o_ack, betas)
UCI_PLANS = [(72, 12, 4, 1024, 8, 1, 2, 2.0, 2.0, 2.0),
             (72, 12, 2, 680, 20, 0, 1, 2.0, 2.0, 2.0),
             (300, 12, 4, 7776, 30, 1, 2, 2.0, 1.25, 2.5),
             (1200, 12, 4, 44064, 30, 1, 2, 2.0, 2.0, 2.0),
             (36, 12, 6, 1000, 11, 1, 0, 20.0, 5.0, 2.0),
             (48, 10, 2, 300, 16, 1, 2, 6.25, 2.0, 2.0, False)]


@pytest.mark.parametrize("plan", UCI_PLANS)
def test_make_uci_maps_equals_reference(plan):
    ours, ref = uci.make_uci_maps(*plan), j_uci.make_uci_maps(*plan)
    _eq_fields(ours, ref)
    assert ours.qp_cqi and (ours.qp_ri or ours.qp_ack)


def test_ul_wiener_and_time_weights_equal_reference():
    for args in ((6, 6, 0, 0.1), (25, 6, 2, 0.01), (25, 25, 0, 10 ** -0.75)):
        np.testing.assert_array_equal(pusch._ul_wiener_matrix(*args),
                                      j_pusch._ul_wiener_matrix(*args))
    for pm in (scfdma.make_pusch_map(25, 25), scfdma.make_pusch_map(
            25, 6, 2, rb_offset2=14), scfdma.make_pusch_map(25, 4, 0,
                                                            srs=True)):
        key = (tuple(pm.data_syms.tolist()), True, pm.hopped)
        np.testing.assert_array_equal(pusch._ul_time_weights(*key),
                                      j_pusch._ul_time_weights(*key))
    cfg = dict(mcs=20, n_rb_alloc=100, g_override=None)
    for k in ("tbs", "Qm", "G", "n_data_symbols"):
        assert getattr(pusch.UlschConfig(**cfg), k) == \
            getattr(j_pusch.UlschConfig(**cfg), k)


# ------------------------------------------------------------- SC-FDMA --

@pytest.mark.parametrize("M", [12, 36, 300, 1200])
def test_transform_precoding_within_f32_of_reference(M):
    """Unitary DFT/IDFT matmuls: within 2e-6 (M <= 300) or 5e-6 (M =
    1200) of the outputs' scale; the round trip returns the input."""
    x = _cplx(2, 3, M)
    got = scfdma.transform_precode(torch.from_numpy(x))
    want = j_sc.transform_precode(jnp.asarray(x))
    tol = 5e-6 if M == 1200 else 2e-6
    assert _rel(got.numpy(), want) < tol
    back = scfdma.transform_deprecode(got)
    assert _rel(back.numpy(), j_sc.transform_deprecode(want)) < tol
    assert _rel(back.numpy(), x) < tol


@pytest.mark.parametrize("args", [(6, 6, 0), (25, 6, 2, True, False, 14)],
                         ids=["6", "25 hopped"])
def test_grid_fill_extract_within_f32_of_reference(args):
    pm, jpm = scfdma.make_pusch_map(*args), j_sc.make_pusch_map(*args)
    dmrs = ulref.pusch_dmrs(pm.m_sc, u=4)
    sym = _cplx(3, len(pm.interleave))
    got = scfdma.pusch_fill_grid(torch.from_numpy(sym), pm, dmrs)
    want = j_sc.pusch_fill_grid(jnp.asarray(sym), jpm, dmrs)
    assert got.shape == want.shape and _rel(got.numpy(), want) < 2e-6
    assert np.array_equal(got.numpy() == 0, np.asarray(want) == 0)
    (d, m), (jd, jm) = scfdma.pusch_extract(got, pm), j_sc.pusch_extract(
        want, jpm)
    assert _rel(d.numpy(), jd) < 2e-6 and _rel(m.numpy(), jm) < 2e-6
    serial = scfdma.pusch_deinterleave(scfdma.transform_deprecode(d), pm)
    assert _rel(serial.numpy(), j_sc.pusch_deinterleave(
        j_sc.transform_deprecode(jd), jpm)) < 2e-6
    assert _rel(serial.numpy(), sym) < 2e-6
    fp, jfp = FrameParms(n_rb=args[0]), JFrameParms(n_rb=args[0])
    t = _cplx(2, fp.samples_per_tti)
    assert _rel(scfdma.apply_7_5_khz(torch.from_numpy(t), fp).numpy(),
                j_sc.apply_7_5_khz(jnp.asarray(t), jfp)) < 1e-6
    assert _rel(scfdma.remove_7_5_khz(torch.from_numpy(t), fp).numpy(),
                j_sc.remove_7_5_khz(jnp.asarray(t), jfp)) < 1e-6


@pytest.mark.parametrize("args", [(6, 6, 0), (25, 6, 2, True, False, 14),
                                  (100, 100, 0)],
                         ids=["6", "25 hopped", "100"])
def test_estimator_and_equalizer_within_f32_of_reference(args):
    """ul_estimate_channel (the reference takes its packed matrix, the
    port the complex one) within 1e-5 of the estimate's scale;
    scfdma_mmse_equalize within 1e-5 (xf) and 1e-5 (n0_eff)."""
    pm, jpm = scfdma.make_pusch_map(*args), j_sc.make_pusch_map(*args)
    n0 = 10 ** -1.2
    dmrs = ulref.pusch_dmrs(pm.m_sc)
    rx = _cplx(2, 2, pm.m_sc)
    got = pusch.ul_estimate_channel(torch.from_numpy(rx), dmrs, pm,
                                    pusch.make_ul_wiener(pm, n0, "cpu"))
    want = j_pusch.ul_estimate_channel(jnp.asarray(rx), dmrs, jpm,
                                       jnp.asarray(j_pusch.make_ul_wiener(
                                           jpm, n0)))
    assert got.shape == want.shape and _rel(got.numpy(), want) < 1e-5
    y = _cplx(2, len(pm.data_syms), pm.m_sc)
    H = np.array(want)
    xf, ne = pusch.scfdma_mmse_equalize(torch.from_numpy(y),
                                        torch.from_numpy(H),
                                        float(np.float32(n0)))
    jxf, jne = j_pusch.scfdma_mmse_equalize(jnp.asarray(y), jnp.asarray(H),
                                            jnp.float32(n0))
    assert _rel(xf.numpy(), jxf) < 1e-5 and _rel(ne.numpy(), jne) < 1e-5


# ------------------------------------------------------------------- UCI --

@pytest.mark.parametrize("O", [4, 11, 16, 30])
def test_cqi_encode_device_equals_reference(O):
    Q = 4 * 72 if O > 11 else 100
    bits = RNG.integers(0, 2, (6, O)).astype(np.int32)
    got = uci.cqi_encode_device(torch.from_numpy(bits), Q).numpy()
    want = np.asarray(j_uci.cqi_encode_device(jnp.asarray(bits), Q))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for b, row in zip(bits, got):
        np.testing.assert_array_equal(row, j_uci.cqi_encode_host(b, Q))
        np.testing.assert_array_equal(row, uci.cqi_encode_host(b, Q))


@pytest.mark.parametrize("O", [4, 8, 11, 16, 30])
def test_cqi_decode_equals_reference(O):
    """Noisy LLRs of coded payloads, some beyond repair: bits and CRC
    flags equal the reference's."""
    Q = 4 * 72 if O > 11 else 96
    bits = RNG.integers(0, 2, (16, O)).astype(np.int32)
    code = np.stack([j_uci.cqi_encode_host(b, Q) for b in bits])
    sigma = np.linspace(0.3, 5.0, 16)[:, None]
    llr = ((1.0 - 2.0 * code) + sigma * RNG.standard_normal(code.shape)
           ).astype(np.float32)
    got_b, got_ok = uci.cqi_decode(torch.from_numpy(llr), O)
    want_b, want_ok = j_uci.cqi_decode(jnp.asarray(llr), O)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    right = (got_b.numpy() == bits).all(axis=1)
    assert right.any() and not right.all(), right


@pytest.mark.parametrize("Qm", [2, 4, 6])
def test_ri_ack_symbols_and_decisions_equal_reference(Qm):
    o1 = RNG.integers(0, 2, 8).astype(np.int32)
    o2 = RNG.integers(0, 2, (8, 2)).astype(np.int32)
    for qp in (1, 5, 12):
        np.testing.assert_array_equal(
            uci.uci1_symbols(torch.from_numpy(o1), Qm, qp).numpy(),
            np.asarray(j_uci.uci1_symbols(jnp.asarray(o1), Qm, qp)))
        np.testing.assert_array_equal(
            uci.uci2_symbols(torch.from_numpy(o2), Qm, qp).numpy(),
            np.asarray(j_uci.uci2_symbols(jnp.asarray(o2), Qm, qp)))
        llr = RNG.standard_normal((64, qp, 2)).astype(np.float32)
        llr[0] = 0.0                           # a tie: both take bit 0 / h 0
        llr[1, :, :] = np.where(np.arange(2) == 0, 1.0, -1.0)
        np.testing.assert_array_equal(
            uci.uci1_decode(torch.from_numpy(llr)).numpy(),
            np.asarray(j_uci.uci1_decode(jnp.asarray(llr))))
        np.testing.assert_array_equal(
            uci.uci2_decode(torch.from_numpy(llr)).numpy(),
            np.asarray(j_uci.uci2_decode(jnp.asarray(llr))))


@pytest.mark.parametrize("plan", UCI_PLANS[:3])
def test_uci_multiplex_and_demultiplex_equal_reference(plan):
    m, jm = uci.make_uci_maps(*plan), j_uci.make_uci_maps(*plan)
    B = 3
    data = _cplx(B, m.G_data // m.Qm)
    cqi = _cplx(B, m.qp_cqi)
    ri = _cplx(B, m.qp_ri) if m.qp_ri else None
    ack = _cplx(B, m.qp_ack) if m.qp_ack else None

    def t(a):
        return None if a is None else torch.from_numpy(a)

    def j(a):
        return None if a is None else jnp.asarray(a)
    got = uci.uci_multiplex(t(data), t(cqi), t(ri), t(ack), m)
    want = j_uci.uci_multiplex(j(data), j(cqi), j(ri), j(ack), jm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    llr = RNG.standard_normal((B, m.C, m.M, m.Qm)).astype(np.float32)
    got = uci.uci_demultiplex(torch.from_numpy(llr), m)
    want = j_uci.uci_demultiplex(jnp.asarray(llr), jm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# --------------------------------------------------------------- channel --

@pytest.mark.parametrize("name", ["EVA", "ETU", "AWGN"])
def test_channel_at_explicit_subcarriers_within_f32_of_reference(name):
    """freq_response_at and apply_channel_bins: within 1e-6 of scale."""
    fp, jfp = FrameParms(n_rb=25), JFrameParms(n_rb=25)
    cm, jcm = channels.ChannelModel(name, fp), j_ch.ChannelModel(name, jfp)
    f_idx = tuple((2 * 12 + np.arange(72) - 150).tolist())
    taps = _cplx(3, cm.n_taps)
    got = cm.freq_response_at(torch.from_numpy(taps), f_idx)
    want = jcm.freq_response_at(jnp.asarray(taps), f_idx)
    assert got.shape == want.shape and _rel(got.numpy(), want) < 1e-6
    if name != "AWGN":
        np.testing.assert_array_equal(cm._phase_matrix_at(f_idx),
                                      jcm._phase_matrix_at(f_idx))
    bins = np.mod(np.asarray(f_idx), fp.n_fft).astype(np.int32)
    grid = _cplx(3, 14, fp.n_fft)
    g = channels.apply_channel_bins(torch.from_numpy(grid), got, bins,
                                    fp.n_fft)
    jg = j_ch.apply_channel_bins(jnp.asarray(grid), want, bins, fp.n_fft)
    assert _rel(g.numpy(), jg) < 1e-6
