"""The per-TTI procedures of the PyTorch port (sched/: EnbTx, UeRx, UeTx,
EnbRx, HarqFeedbackState) against the JAX package's on the same inputs.

Grids and waveforms within 1e-5 of their scale; the UE receiver on one
received grid: CFI, every DCI size hypothesis (found and payload), PHICH
decisions, TB bits and flags equal, the decoder's LLRs and the
measurements within 1e-5 of their scale; the eNB
receiver: TB bits and flags equal, LLRs and SRS statistics within 1e-5 of
their scale; HARQ bookkeeping traces equal. 25 PRB (6 where it suffices),
batch 4, 4 turbo iterations, decoder window 96 on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.ops import gold as jgold
from openair4g_tpu.ops.llr import demap_llr as j_demap
from openair4g_tpu.ops.llr import map_symbols as j_map
from openair4g_tpu.phy import ofdm as jofdm
from openair4g_tpu.phy import pusch as jpusch
from openair4g_tpu.phy import scfdma as jscfdma
from openair4g_tpu.phy.channel_est import estimate_channel as j_estimate
from openair4g_tpu.phy.channel_est import make_wiener_stack as j_wiener
from openair4g_tpu.phy.dci_formats import n_rbg, pack_dci_format1
from openair4g_tpu.phy.pdcch import ue_search_candidates
from openair4g_tpu.phy.srs import SrsConfig as JSrsConfig
from openair4g_tpu.ops.equalize_llr import mrc_llr as j_mrc
from openair4g_tpu.sched import enb_rx as jrx
from openair4g_tpu.sched import enb_tx as jtx
from openair4g_tpu.sched import ue_rx as jue
from openair4g_tpu.sched import ue_tx as jutx
from openair4g_tpu_torch.phy.channel_est import make_wiener_stack
from openair4g_tpu_torch.phy.srs import SrsConfig
from openair4g_tpu_torch.sched import (CellConfig, EnbRx, EnbTx,
                                       HarqFeedbackState, UeRx, UeTx,
                                       UeUlConfig)
from openair4g_tpu_torch.sched.ue_rx import tm_ue_format

torch.set_num_threads(1)

B = 4


def _rel(got, want):
    """max |got - want| over want's scale (over 1 where want is all 0)."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / (np.abs(want).max() or 1.0)


def _noise(rng, shape, n0):
    """Complex AWGN of variance n0, complex64."""
    return (np.sqrt(n0 / 2) * (rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


# ----------------------------------------------------------------- EnbTx --

@pytest.mark.parametrize("cell", [
    dict(n_rb=25, rb_start=4, n_prb=12, mcs=6),
    dict(n_rb=6, n_prb=6, mcs=4, subframe=3, tdd=True, n_id_cell=5),
    dict(n_rb=50, n_pdcch=2, n_prb=50, mcs=16, n_phich_groups=2)],
    ids=["25 PRB", "6 PRB TDD", "50 PRB"])
def test_enb_tx_subframe_equals_reference(cell):
    rng = np.random.default_rng(1)
    jenb, enb = jtx.EnbTx(jtx.CellConfig(**cell)), \
        EnbTx(CellConfig(**cell), device="cpu")
    np.testing.assert_array_equal(enb.pcfich_syms, jenb.pcfich_syms)
    np.testing.assert_array_equal(enb.pdcch_syms, jenb.pdcch_syms)
    np.testing.assert_array_equal(enb.dci_payload, jenb.dci_payload)
    np.testing.assert_array_equal(enb.phich_bin, jenb.phich_bin)
    n = enb.am.n_data_re
    assert n == jenb.am.n_data_re
    syms = ((rng.integers(0, 2, (B, n)) * 2 - 1)
            + 1j * (rng.integers(0, 2, (B, n)) * 2 - 1)).astype(
                np.complex64) / np.sqrt(2)
    ack = np.array([1, 0, 0, 1], np.int32)
    want = jenb.data_subframe(jnp.asarray(syms), jnp.asarray(ack))
    got = enb.data_subframe(torch.from_numpy(syms), torch.from_numpy(ack))
    assert _rel(got, want) < 1e-5
    want = jenb.data_waveform(jnp.asarray(syms))
    assert _rel(enb.data_waveform(torch.from_numpy(syms)), want) < 1e-5
    for sfn in range(4):
        np.testing.assert_array_equal(enb.sync_subframe_host(sfn),
                                      jenb.sync_subframe_host(sfn))


def test_enb_tx_channels_disjoint():
    """PDSCH allocation, pilots, PCFICH, PHICH and PDCCH never collide
    (tests/test_fullsim.py's check on the port's maps)."""
    enb = EnbTx(CellConfig(n_rb=25, rb_start=4, n_prb=12, mcs=6),
                device="cpu")
    sets = {
        "pdsch": set(zip(enb.am.data_sym.tolist(), enb.am.data_sc.tolist())),
        "pilot": set(zip(enb.gm.pilot_sym.tolist(),
                         enb.gm.pilot_sc.tolist())),
        "pcfich": set(zip(enb.crm.pcfich_sym.tolist(),
                          enb.crm.pcfich_sc.tolist())),
        "pdcch": set(zip(enb.crm.pdcch_sym.tolist(),
                         enb.crm.pdcch_sc.tolist())),
        "phich": set((0, int(s)) for s in enb.phich_sc[0])}
    names = list(sets)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            assert not sets[a] & sets[b], (a, b)


def test_set_dcis_equals_reference_and_refuses_overlap():
    cell = dict(n_rb=25, n_pdcch=2, mcs=4)
    jenb, enb = jtx.EnbTx(jtx.CellConfig(**cell)), \
        EnbTx(CellConfig(**cell), device="cpu")
    f1 = pack_dci_format1(25, (1 << n_rbg(25)[0]) - 1, 9, 2, 1, 0)
    dcis = [(enb.dci_payload, 0x1234, 4, 0), (f1, 0x1234, 2, 6)]
    jenb.set_dcis(dcis)
    enb.set_dcis(dcis)
    np.testing.assert_array_equal(enb.pdcch_syms, jenb.pdcch_syms)
    np.testing.assert_array_equal(enb._pdcch.numpy(), jenb.pdcch_syms)
    with pytest.raises(ValueError, match="overlap"):
        enb.set_dcis([(enb.dci_payload, 0x1234, 4, 0), (f1, 0x1234, 2, 2)])


# ------------------------------------------------------------------ UeRx --

def _reference_llrs(jue_rx, rgrid, n0, W):
    """The reference receiver's PDSCH LLRs into its decoder, by its own
    functions (sched/ue_rx.py:144-151)."""
    H = j_estimate(rgrid, jue_rx.gm, W, time_avg=True)
    am = jue_rx.am
    y = rgrid[:, jnp.asarray(am.data_sym), jnp.asarray(am.data_bin)]
    h = H[:, jnp.asarray(am.data_sym), jnp.asarray(am.data_sc)]
    llr = j_mrc(y[..., None], h[..., None], n0,
                jue_rx.codec.cfg.Qm).reshape(y.shape[0], -1)
    return np.asarray(jgold.unscramble_llrs(llr, jue_rx.scr_seq))


@pytest.mark.parametrize("snr", [12.0, -3.0])
def test_ue_rx_receive_equals_reference(snr):
    """TM2: the 1A grant and a format-1 DCI in the UE-specific space, with
    a PDSCH TB and the PHICH ACK bits, through AWGN; the two size
    hypotheses as tests/test_dci_air.py's multi-size search."""
    rng = np.random.default_rng(2)
    cell = dict(n_rb=25, n_pdcch=2, mcs=4, dci_L=4, dci_cce_offset=0)
    jcell = jtx.CellConfig(**cell)
    jenb = jtx.EnbTx(jcell)
    jue_rx = jue.UeRx(jcell, n_turbo_iter=4, tm=2)
    ue = UeRx(CellConfig(**cell), n_turbo_iter=4, tm=2, device="cpu",
              decoder_window=96)
    assert [h[:2] for h in ue.size_hyps] == [h[:2] for h in jue_rx.size_hyps]
    c1 = next(c for c in ue_search_candidates(jenb.crm.n_cce, jcell.rnti,
                                              jcell.subframe)
              if c.cce_offset >= jcell.dci_L)
    f1 = pack_dci_format1(25, (1 << n_rbg(25)[0]) - 1, 9, 2, 1, 0)
    jenb.set_dcis([(jenb.dci_payload, jcell.rnti, jcell.dci_L, 0),
                   (f1, jcell.rnti, c1.L, c1.cce_offset)])
    tb = rng.integers(0, 2, (B, jue_rx.codec.cfg.tbs)).astype(np.int32)
    e = jgold.scramble_bits(jue_rx.codec.encode(jnp.asarray(tb)),
                            jue_rx.scr_seq)
    sym = j_map(e, jue_rx.codec.cfg.Qm).astype(jnp.complex64)
    ack = jnp.asarray([0, 1, 1, 0], jnp.int32)
    t = np.asarray(jofdm.ofdm_modulate(jenb.data_subframe(sym, ack),
                                       jenb.fp))
    n0 = float(np.float32(10.0 ** (-snr / 10.0)))
    rgrid = np.array(jofdm.ofdm_demodulate(
        jnp.asarray(t + _noise(rng, t.shape, n0)), jenb.fp))

    Wj = j_wiener(jue_rx.gm, n0 / 4.0)
    np.testing.assert_array_equal(make_wiener_stack(ue.gm, n0 / 4.0), Wj)
    want = jue_rx.receive(jnp.asarray(rgrid), jnp.float32(n0),
                          jnp.asarray(Wj))
    got = ue.receive(torch.from_numpy(rgrid), n0, ue.make_wiener(n0))
    for key in ("cfi_hat", "dci_found", "dci_payload", "tb", "tb_ok",
                "ack", "phich_ack"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert set(got["dci"]) == set(want["dci"]) == {"1a", "1"}
    for fmt, (f, p) in want["dci"].items():
        np.testing.assert_array_equal(got["dci"][fmt][0].numpy(),
                                      np.asarray(f), err_msg=fmt)
        np.testing.assert_array_equal(got["dci"][fmt][1].numpy(),
                                      np.asarray(p), err_msg=fmt)
    for key, val in want["meas"].items():
        assert _rel(got["meas"][key], val) < 1e-5, key
    rg = torch.from_numpy(rgrid)
    H = ue.channel(rg, ue.make_wiener(n0))
    want_llr = _reference_llrs(jue_rx, jnp.asarray(rgrid), jnp.float32(n0),
                               jnp.asarray(Wj))
    assert _rel(ue.pdsch_llrs(rg, H, n0), want_llr) < 1e-5
    if snr > 10:
        assert bool(got["tb_ok"].all()) and bool(got["dci"]["1"][0].all())
        np.testing.assert_array_equal(got["phich_ack"].numpy(),
                                      np.asarray(ack, bool))
        assert (got["cfi_hat"] == 2).all()
    else:
        assert not bool(got["tb_ok"].all())


def test_tm_ue_format_equals_reference():
    for tm in (1, 2, 3, 4, 5, 6, 7):
        for n_rb in (6, 25, 100):
            assert tm_ue_format(tm, n_rb) == jue.tm_ue_format(tm, n_rb)
    with pytest.raises(ValueError):
        tm_ue_format(9, 25)


# ------------------------------------------------------------ UeTx, EnbRx --

def _ul_pair(cfg_kw, srs_kw=None):
    jcfg = jutx.UeUlConfig(**cfg_kw, srs=None if srs_kw is None
                           else JSrsConfig(**srs_kw))
    cfg = UeUlConfig(**cfg_kw, decoder_window=96, srs=None if srs_kw is None
                     else SrsConfig(**srs_kw))
    jue_tx = jutx.UeTx(jcfg)
    return jue_tx, jrx.EnbRx(jue_tx), UeTx(cfg, device="cpu")


def _reference_pusch_llrs(jenb_rx, waveform, n0):
    """The reference eNB's data LLRs into its decoder, by its own functions
    (sched/enb_rx.py:45-62)."""
    t = jscfdma.remove_7_5_khz(waveform, jenb_rx.fp)
    rgrid = jofdm.ofdm_demodulate(t, jenb_rx.fp)
    y, dmrs_rx = jscfdma.pusch_extract(rgrid, jenb_rx.pm)
    W = jnp.asarray(jpusch.make_ul_wiener(jenb_rx.pm, float(n0)))
    H = jpusch.ul_estimate_channel(dmrs_rx, jenb_rx.tx.dmrs, jenb_rx.pm, W)
    xf, n0_eff = jpusch.scfdma_mmse_equalize(y, H, n0)
    Qm = jenb_rx.tx.ulsch.Qm
    llr = j_demap(jscfdma.transform_deprecode(xf), n0_eff, Qm)
    flat = llr.reshape(llr.shape[0], -1, Qm)
    inv = np.empty_like(jenb_rx.pm.interleave)
    inv[jenb_rx.pm.interleave] = np.arange(len(inv), dtype=np.int32)
    return np.asarray(jgold.unscramble_llrs(
        flat[:, jnp.asarray(inv)].reshape(llr.shape[0], -1),
        jenb_rx.tx.scr_seq))


@pytest.mark.parametrize("snr,srs", [(12.0, True), (3.0, True),
                                     (12.0, False)])
def test_pusch_equals_reference(snr, srs):
    """UeTx.pusch_subframe (with the SRS the last symbol, shortening the
    grant to 11 data symbols) and EnbRx.receive_pusch on the same noisy
    waveform: TB bits and flags equal; LLRs and the SRS estimate within
    1e-5 of their scale. (Far above 12 dB the LLRs' scale 1 / n0_eff,
    n0_eff = (1 - rho) / rho with rho near 1, cancels in float32 and two
    summation orders part by 1e-4 of scale.)"""
    rng = np.random.default_rng(3)
    if srs:
        jue_tx, jenb_rx, ue = _ul_pair(
            dict(n_rb=25, mcs=6, n_rb_alloc=20, n_turbo_iter=4),
            dict(n_rb=25, srs_bw_rb=20))
        assert len(ue.pm.data_syms) == 11
    else:
        jue_tx, jenb_rx, ue = _ul_pair(dict(n_rb=6, mcs=6, n_rb_alloc=6,
                                            n_turbo_iter=4))
    enb = EnbRx(ue)
    tb = rng.integers(0, 2, (B, ue.ulsch.tbs)).astype(np.int32)
    for rv in (2, 0):     # rv 0 last: the receiver decodes at rv 0
        want_w = np.asarray(jue_tx.pusch_subframe(jnp.asarray(tb), rv=rv))
        assert _rel(ue.pusch_subframe(torch.from_numpy(tb), rv=rv),
                    want_w) < 1e-5
    n0 = float(np.float32(10.0 ** (-snr / 10.0)))
    rx = want_w + _noise(rng, want_w.shape, n0)
    want = jenb_rx.receive_pusch(jnp.asarray(rx), jnp.float32(n0))
    got = enb.receive_pusch(torch.from_numpy(rx), n0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    want_llr = _reference_pusch_llrs(jenb_rx, jnp.asarray(rx),
                                     jnp.float32(n0))
    assert _rel(enb.pusch_llrs(torch.from_numpy(rx), n0)[0], want_llr) < 1e-5
    if srs:
        for g, w in zip(got[2], want[2]):
            assert _rel(g, w) < 1e-5
    else:
        assert got[2] is None and want[2] is None
    if snr > 10:
        assert bool(got[1].all())
        np.testing.assert_array_equal(got[0].numpy(), tb)


def test_pucch_equals_reference():
    """Format 1a ACK/NACK: the waveform within 1e-5 of its scale, the
    decision variable on the same noisy waveform within 1e-5, the signs
    those sent."""
    jue_tx, jenb_rx, ue = _ul_pair(dict(n_rb=25, pucch_rb=24, subframe=3,
                                        n_cs1=2, n_oc=1))
    d = np.array([1.0, -1.0, 1.0, -1.0], np.complex64)
    want_w = np.asarray(jue_tx.pucch_subframe(jnp.asarray(d)))
    assert _rel(ue.pucch_subframe(torch.from_numpy(d)), want_w) < 1e-5
    n0 = 10.0 ** -0.6
    rx = want_w + _noise(np.random.default_rng(4), want_w.shape, n0)
    want = np.asarray(jenb_rx.receive_pucch(jnp.asarray(rx), n0))
    got = EnbRx(ue).receive_pucch(torch.from_numpy(rx), n0)
    assert _rel(got, want) < 1e-5
    np.testing.assert_array_equal(np.sign(got.numpy().real), d.real)


def test_harq_feedback_traces_equal_reference():
    """The same decode outcomes through both bookkeepers: every action, rv
    and counter equal, across rounds exhausted and a dropped UE."""
    crc = np.random.default_rng(5).random(200) < 0.35
    for max_rounds, max_errs in ((4, 20), (4, 5), (2, 3)):
        st = HarqFeedbackState(max_rounds=max_rounds,
                               max_consecutive_errors=max_errs)
        jst = jrx.HarqFeedbackState(max_rounds=max_rounds,
                                    max_consecutive_errors=max_errs)
        trace = [(st.feedback(bool(c)), jst.feedback(bool(c))) for c in crc]
        assert [g for g, _ in trace] == [w for _, w in trace]
        assert (st.round, st.consecutive_errors, st.dropped, st.n_ack,
                st.n_nack) == (jst.round, jst.consecutive_errors,
                               jst.dropped, jst.n_ack, jst.n_nack)
    st = HarqFeedbackState(max_rounds=4, max_consecutive_errors=5)
    assert st.feedback(True)["action"] == "new_tx"
    assert [st.feedback(False)["rv"] for _ in range(3)] == [2, 3, 1]
    assert st.feedback(False)["action"] == "new_tx"
    assert st.feedback(False)["action"] == "dropped" and st.dropped


def test_sched_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = CellConfig(n_rb=6, n_prb=6)
    for build in (lambda d: EnbTx(cell, device=d),
                  lambda d: UeRx(cell, device=d),
                  lambda d: UeTx(UeUlConfig(n_rb=6, n_rb_alloc=6), d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(None)
        assert build("cpu").device == torch.device("cpu")
