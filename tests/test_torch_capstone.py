"""The port's single-UE capstone (sim/capstone.py) against the JAX package
at 25 PRB on the CPU: the downlink air's transmit and blind receive, the
uplink air's composite subframes, the cold cell search, and the whole
attach ladder.

Both packages draw every noise sample from numpy Generators seeded alike
and add it on the host before the upload, so with equal seeds the port
consumes the reference's draws: the waves agree to float32 rounding, and
every decision (DCI, CRC, payload, cell) is equal. The ladders are held
to every assertion of the reference's tests (tests/test_capstone.py,
tests/test_paging.py); equality with the JAX run, trace for trace, is in
the slow set, since each JAX ladder takes minutes of compiles."""
import dataclasses

import numpy as np
import pytest
import torch

from openair4g_tpu.sim import capstone as J
from openair4g_tpu_torch.rrc.paging import (PagingConfig, ue_paging_id,
                                            is_paging_occasion)
from openair4g_tpu_torch.sim import capstone as P
from openair4g_tpu_torch.utils.opt import (read_pcap, KIND_MAC, KIND_IP,
                                           DIR_DL, DIR_UL)

torch.set_num_threads(1)

CFG = dict(n_rb=25, snr_db=12.0, seed=0)
# The clean waves: the same float32 operations in another order (XLA's
# FFT and scatter against torch's), held relative to the wave's peak.
WAVE_RTOL = 2e-6


def _pair(seed: int = 0):
    """The reference's and the port's DlAir with equal Generators."""
    return (J.DlAir(J.CapstoneConfig(**CFG), np.random.default_rng(seed)),
            P.DlAir(P.CapstoneConfig(**CFG), np.random.default_rng(seed),
                    "cpu"))


def test_config_is_the_reference_s_plus_the_decoder_window():
    def defaults(cls):
        return {f.name: dataclasses.astuple(f.default)
                if dataclasses.is_dataclass(f.default) else f.default
                for f in dataclasses.fields(cls)}
    ref, got = defaults(J.CapstoneConfig), defaults(P.CapstoneConfig)
    assert got.pop("decoder_window") is None
    assert got == ref
    assert (P.SI_RNTI, P.P_RNTI, P.LCID_SRB1, P.LCID_DRB) == \
        (J.SI_RNTI, J.P_RNTI, J.LCID_SRB1, J.LCID_DRB)


def test_tb_bytes_round_trip():
    data = bytes(range(40))
    tb = P._bytes_to_tb(data, 400)
    np.testing.assert_array_equal(tb, J._bytes_to_tb(data, 400))
    assert P._tb_to_bytes(tb)[:40] == data


# (subframe, pdsch, UL grants): SIB-like data on the common allocation
# (DCI 1C), dedicated data (DCI 1A) beside a format-0 grant for another
# UE, and a format-0 grant alone (no PDSCH: its region carries zeros).
TX_CASES = {
    "common 1C": (5, ("common", 0xFFFF, bytes(range(20))), ()),
    "dedicated 1A + format 0": (
        3, ("ded", 0x4601, bytes(range(7, 107))),
        ((0x4602, J.Alloc(0, 6, 8)),)),
    "format 0 alone": (7, None, ((0x4601, J.Alloc(12, 6, 8)),)),
}


def _port_grants(grants):
    return tuple((r, P.Alloc(a.rb_start, a.n_prb, a.mcs)) for r, a in grants)


@pytest.mark.parametrize("case", list(TX_CASES))
def test_transmit_clean_and_receive_equal_the_reference(case):
    """transmit_clean's wave within WAVE_RTOL of the reference's; the JAX
    UE's received grid (its noise included), carried across, gives an
    equal receive() result: the PDSCH bytes, the UL grant's fields."""
    sf, pdsch, grants = TX_CASES[case]
    jdl, pdl = _pair()
    jw = np.asarray(jdl.transmit_clean(sf, pdsch, grants))
    pw = pdl.transmit_clean(sf, pdsch, _port_grants(grants))
    assert pw.dtype == np.complex64 and pw.shape == jw.shape
    scale = np.abs(jw).max()
    assert np.abs(pw - jw).max() <= WAVE_RTOL * scale
    jgrid = jdl.ue_demod(jw)
    rntis = [0xFFFF] if pdsch is None or pdsch[0] == "common" else []
    crnti = None if pdsch and pdsch[0] == "common" else 0x4601
    want = jdl.receive(jgrid, sf, rntis, crnti)
    got = pdl.receive(torch.as_tensor(np.asarray(jgrid)), sf, rntis, crnti)
    assert got == want
    if pdsch is not None:
        assert got["pdsch"] == (pdsch[1], pdsch[2] + bytes(
            len(got["pdsch"][1]) - len(pdsch[2])))
    else:
        assert got["ul_grant"]["is_format0"] and got["pdsch"] is None


def test_ue_demod_consumes_the_reference_draws():
    """The port's own noise (same Generator seed) gives the reference's
    grid to float32 rounding, and both Generators end in one state."""
    jdl, pdl = _pair(seed=7)
    sf, pdsch, grants = TX_CASES["dedicated 1A + format 0"]
    jw = np.asarray(jdl.transmit_clean(sf, pdsch, grants))
    jgrid = np.asarray(jdl.ue_demod(jw))
    pgrid = pdl.ue_demod(jw).numpy()
    assert np.abs(pgrid - jgrid).max() <= 1e-5 * np.abs(jgrid).max()
    assert jdl.rng.integers(1 << 30) == pdl.rng.integers(1 << 30)


def _ul_pair(seed: int):
    return (J.UlAir(J.CapstoneConfig(**CFG), np.random.default_rng(seed)),
            P.UlAir(P.CapstoneConfig(**CFG), np.random.default_rng(seed),
                    "cpu"))


def _ul_entries(alloc_cls, cfg, tbs_bytes):
    """Two FDM grants on disjoint PRBs in subframe 4, and two Msg3 PDUs
    on the one RAR grant in subframe 1 (a collision: the waves sum)."""
    ul = alloc_cls(*dataclasses.astuple(cfg.ul))
    other = alloc_cls(ul.rb_start + 2 * ul.n_prb, ul.n_prb, ul.mcs)
    msg3 = alloc_cls(*dataclasses.astuple(cfg.msg3))
    n = tbs_bytes(ul, 4)
    m = tbs_bytes(msg3, 1)
    fdm = [(ul, 0x4601, 4, bytes((i * 3) & 0xFF for i in range(n))),
           (other, 0x4602, 4, bytes((i * 5 + 1) & 0xFF for i in range(n)))]
    coll = [(msg3, 0x4601, 1, bytes(range(m))),
            (msg3, 0x4601, 1, bytes(range(1, m + 1)))]
    return {"fdm": fdm, "msg3 collision": coll}


@pytest.mark.parametrize("case", ["fdm", "msg3 collision"])
def test_ul_run_multi_equals_the_reference(case):
    """UlAir.run_multi from equal seeds: the same outputs (each UE's bytes
    through FDM; on the one Msg3 grant, both receivers decode the same
    composite), the same draws."""
    jul, pul = _ul_pair(seed=11)
    want = jul.run_multi(_ul_entries(J.Alloc, jul.cfg, jul.tbs_bytes)[case])
    got = pul.run_multi(_ul_entries(P.Alloc, pul.cfg, pul.tbs_bytes)[case])
    assert got == want
    if case == "fdm":
        assert all(g is not None for g in got)
    else:
        assert got[0] == got[1]
    assert jul.rng.integers(1 << 30) == pul.rng.integers(1 << 30)


def test_cold_sync_finds_the_reference_cell():
    """cold_sync on equal seeds: the same capture offset and noise, the
    same PCI and MIB, the same trace line."""
    jsim = J.FullStackSim(J.CapstoneConfig(**CFG))
    psim = P.FullStackSim(P.CapstoneConfig(**CFG), device="cpu")
    assert psim.cold_sync() is jsim.cold_sync() is True
    assert psim.trace == jsim.trace == [(0, "UE camped: PCI=0 MIB n_rb=25")]
    assert psim.ue.rrc.state.name == jsim.ue.rrc.state.name
    assert psim.ue.rrc.n_id_cell == jsim.ue.rrc.n_id_cell == 0
    assert psim.rng.integers(1 << 30) == jsim.rng.integers(1 << 30)


def _first(res, substr):
    hits = [tti for tti, ev in res["trace"] if substr in ev]
    assert hits, f"missing trace event {substr!r}"
    return hits[0]


def test_full_stack_over_the_air(tmp_path):
    """tests/test_capstone.py::test_full_stack_over_the_air on the port,
    every assertion of it, and the JAX run's counts at this seed."""
    sim = P.FullStackSim(P.CapstoneConfig(snr_db=12.0, seed=0),
                         artifact_dir=str(tmp_path), device="cpu")
    res = sim.run()

    assert res["registered"], "UE NAS did not reach REGISTERED"
    assert res["mme_registered"], "MME did not see AttachComplete"
    assert res["rrc_connected"]
    assert res["echo_ok"], "IP echo did not traverse the user plane"
    assert res["ue_ip"] != 0
    assert res["as_secured"], "eNB never saw SecurityModeComplete"
    assert res["srb_integrity_on"]
    assert res["srb_int_failures"] == 0
    events = [ev for _, ev in res["trace"]]
    assert next(i for i, e in enumerate(events)
                if "SecurityModeCommand" in e) < \
        next(i for i, e in enumerate(events) if "AS security activated" in e)
    assert res["phy_runs"]["prach"] >= 1
    assert res["phy_runs"]["dl"] >= 10
    assert res["phy_runs"]["ul"] >= 5
    # the JAX run's counts at this seed (CPU)
    assert res["ttis"] == 53
    assert res["phy_runs"] == {"dl": 16, "ul": 6, "prach": 1}

    assert _first(res, "UE camped") <= _first(res, "received SI")
    assert _first(res, "received SI") < _first(res, "sent PRACH")
    assert _first(res, "sent PRACH") <= _first(res, "detected preamble")
    assert _first(res, "detected preamble") < _first(res, "matched RAR")
    assert _first(res, "matched RAR") < _first(res, "Msg3 -> C-RNTI")
    assert _first(res, "Msg3 -> C-RNTI") <= \
        _first(res, "won contention resolution")
    assert _first(res, "won contention") < \
        _first(res, "forwarding initial NAS")
    assert _first(res, "forwarding initial NAS") < \
        _first(res, "DRB established")
    assert _first(res, "DRB established") <= \
        _first(res, "queued uplink IP packet")
    assert _first(res, "queued uplink IP") < \
        _first(res, "received IP packet")

    recs = read_pcap(str(tmp_path / "capstone.pcap"))
    assert len(recs) >= 10
    kinds = {(k, d) for _, k, d, _, _ in recs}
    assert (KIND_MAC, DIR_UL) in kinds and (KIND_MAC, DIR_DL) in kinds
    assert any(k == KIND_IP for _, k, _, _, _ in recs)
    ul_macs = [p for _, k, d, _, p in recs
               if k == KIND_MAC and d == DIR_UL]
    assert any(p[0] & 0x1F == 0 for p in ul_macs)   # LCID 0 = CCCH

    msc = (tmp_path / "capstone.msc").read_text()
    for label in ("PRACH", "RRCConnectionRequest", "InitialUEMessage",
                  "DownlinkNASTransport", "GTP-U"):
        assert label in msc, f"MSC missing {label}"


BIG_NAS = dict(snr_db=12.0, seed=3, big_nas_bytes=450, max_ttis=600)
MT_ATTACH = dict(mt_attach=True, paging_cycle_idx=0, max_ttis=800,
                 snr_db=12.0)


def test_capstone_big_nas_segmentation():
    """tests/test_capstone.py::test_capstone_big_nas_segmentation on the
    port: 450 B of DL NAS over ~100 B grants, reassembled."""
    sim = P.FullStackSim(P.CapstoneConfig(**BIG_NAS), device="cpu")
    res = sim.run()
    assert res["registered"] and res["echo_ok"]
    assert res["big_nas_ok"], "oversized NAS did not reassemble"
    tbs = sim.dl.codec(sim.cfg.ded).cfg.tbs // 8
    assert tbs < 250, tbs


def test_mt_attach_via_paging_over_the_air(tmp_path):
    """tests/test_paging.py::test_mt_attach_via_paging_over_the_air on the
    port: the idle UE is paged at its own occasion, then attaches."""
    sim = P.FullStackSim(P.CapstoneConfig(**MT_ATTACH),
                         artifact_dir=str(tmp_path), device="cpu")
    res = sim.run()
    assert res["paged"], "UE was never paged"
    assert res["registered"] and res["echo_ok"]
    assert 1 <= res["po_monitored"] <= 3
    assert _first(res, "MME pages") < _first(res, "UE paged (MT)")
    assert _first(res, "UE paged (MT)") < _first(res, "sent PRACH")
    t_page = _first(res, "eNB transmits Paging")
    pcfg = PagingConfig(default_paging_cycle=0, paging_nb=2)
    uid = ue_paging_id(sim.cfg.imsi)
    assert is_paging_occasion(pcfg, uid, t_page // 10, t_page % 10)


def test_command_line_on_the_cpu(capsys):
    import json
    P.main(["--device", "cpu", "-s", "12", "--seed", "0"])
    res = json.loads(capsys.readouterr().out)
    assert res["registered"] and res["echo_ok"] and res["ttis"] == 53


def _equal_runs(kw: dict, tmp_path):
    """The JAX and the port ladder on one configuration: every result
    field, the trace, the pcap bytes and the MSC text equal."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    want = J.FullStackSim(J.CapstoneConfig(**kw),
                          artifact_dir=str(jdir)).run()
    got = P.FullStackSim(P.CapstoneConfig(**kw), artifact_dir=str(pdir),
                         device="cpu").run()
    want.pop("artifacts")
    got.pop("artifacts")
    assert got == want
    for name in ("capstone.pcap", "capstone.msc"):
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes()
    return got


@pytest.mark.slow
@pytest.mark.parametrize("kw", [dict(snr_db=12.0, seed=0), BIG_NAS,
                                MT_ATTACH],
                         ids=["ladder", "big NAS", "MT attach"])
def test_whole_ladder_equals_the_jax_run(kw, tmp_path):
    _equal_runs(kw, tmp_path)
