"""The benchmark's Test 11 receiver (phybench/configs/
dl20_dd1x2_mcs26_eva_cfi2.json: the decision-directed estimate over 2 RX
antennas, CFI 2, 4 HARQ rounds, the dlsim SNR convention) on the CPU.

The port's plain DlsimFading against the benchmark's frozen reference
(phybench/reference) at 25 PRB, both fed the same injected draws (the
harness's plan and generator): each round's flags and bit errors equal,
the soft buffers within the tolerance of
phybench/tests/test_phybench_reference.py, at an SNR where rows fail
round 0 and a later round decodes them. The configuration's derived
sizes are the port's at 100 PRB. dd_refine's pilot weight, a cached count
of pilots a subcarrier, equals the scatter of ones it replaced, bit for
bit. A traced 6-PRB dd trial opens estimate.dd inside frontend.estimate,
and dd.joint, dd.decide and dd.refine inside it, and its outputs equal an
untraced trial's."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from openair4g_tpu_torch.phy import channel_est
from openair4g_tpu_torch.phy.resource_grid import make_grid_map
from openair4g_tpu_torch.sim import dlsim
from openair4g_tpu_torch.utils import tracing
from phybench import traffic
from phybench.reference.sim import dlsim as ref_dlsim
from phybench.sims import DlsimFading as drv

torch.set_num_threads(1)

CONFIG = json.loads((Path(__file__).resolve().parent.parent / "phybench"
                     / "configs" / "dl20_dd1x2_mcs26_eva_cfi2.json")
                    .read_text())
PARAMS = CONFIG["params"]
R = PARAMS["n_harq_rounds"]
DEV = torch.device("cpu")
# 25 PRB, 4 trials; at 12 dB (dlsim convention) two of the four fail
# round 0 and round 1 decodes them.
SMALL = {"n_rb": 25}
BATCH, SNR_DB, SEED = 4, 12.0, 5
PREFIX = "oai4g:"
DD_PARENT = {"estimate.dd": "frontend.estimate", "dd.joint": "estimate.dd",
             "dd.decide": "estimate.dd", "dd.refine": "estimate.dd"}


def _trial(mod, params: dict, batch: int, snr_db: float, x: dict):
    sim = mod.DlsimFading(mod.DlsimFadingConfig(**params, batch=batch),
                          device=DEV)
    snr = snr_db + mod.dlsim_snr_offset_db(sim.gm)
    n0 = np.float32(10.0 ** (-snr / 10.0))
    return sim.trial(x["tb"], [x["taps"][r] for r in range(R)],
                     [x["noise"][r] for r in range(R)], n0,
                     sim.wiener(snr), sim.err_var(snr))


@pytest.fixture(scope="module")
def both():
    """(the port's TrialResult, the reference's) on one set of draws."""
    params = {**PARAMS, **SMALL}
    x = traffic.draw(drv.plan(params, {"batch": BATCH}),
                     traffic.generator(SEED, DEV), DEV)
    return (_trial(dlsim, params, BATCH, SNR_DB, x),
            _trial(ref_dlsim, params, BATCH, SNR_DB, x))


@pytest.mark.parametrize("rnd", range(R))
def test_each_round_decides_as_the_reference(both, rnd):
    a, b = (out.rounds[rnd] for out in both)
    assert torch.equal(a.ok, b.ok)
    assert torch.equal(a.dci_ok, b.dci_ok)
    assert torch.equal(a.bit_errs, b.bit_errs)


@pytest.mark.parametrize("rnd", range(R))
def test_each_rounds_soft_buffers_match_the_reference(both, rnd):
    a, b = (out.rounds[rnd] for out in both)
    assert len(a.w_soft) == len(b.w_soft) > 0
    for wa, wb in zip(a.w_soft, b.w_soft):
        torch.testing.assert_close(wa, wb, rtol=1e-5, atol=1e-4)


def test_counts_equal_the_reference(both):
    a, b = both
    assert torch.equal(a.errs, b.errs) and torch.equal(a.reach, b.reach)


def test_harq_decodes_rows_that_failed_round_0(both):
    """The point is on the waterfall: rows fail round 0, every DCI is
    found, and the combined buffers of a later round decode them."""
    out, _ = both
    errs = out.errs.tolist()
    assert 0 < errs[0] < BATCH
    assert errs[-1] < errs[0]
    assert all(bool(r.dci_ok.all()) for r in out.rounds)
    first = ~out.rounds[0].ok
    later = torch.stack([r.ok for r in out.rounds[1:]]).any(dim=0)
    assert bool((first & later).any())


def test_the_configurations_derived_sizes_are_the_ports():
    sim = dlsim.DlsimFading(dlsim.DlsimFadingConfig(**PARAMS, batch=1),
                            device=DEV)
    d, cfg = CONFIG["derived"], sim.dlsch.cfg
    assert (cfg.tbs, cfg.G, cfg.Qm) == (d["tbs"], d["G"], d["qm"])
    assert sim.gm.n_data_re == d["data_res"]
    assert (sim.crm.n_cce, len(sim.dci_cands)) == (55, 20)
    assert d["dci"] == "20 candidates over 55 CCEs"
    assert sim.fp.samples_per_tti == d["samples_per_tti"]


@pytest.mark.parametrize("n_rb, cfi, port",
                         [(6, 2, 0), (25, 2, 0), (100, 2, 0), (100, 1, 1),
                          (50, 3, 0)])
def test_pilot_weight_equals_the_scatter_it_replaced(n_rb, cfi, port):
    """The pilots' weight in dd_refine's per-subcarrier sums: once a
    [nsym * n_sc] field of zeros with a 1.0 written at each pilot (a write
    of a host scalar, which waited on the device at every call), summed
    over the symbols; now the count of pilots on each subcarrier, cached
    with the positions."""
    gm = make_grid_map(n_rb, cfi, 0, 7)
    _, pilot_pos, count = channel_est._dd_positions(gm, port, DEV)
    nsym, n_sc = gm.fp.symbols_per_subframe, gm.fp.n_sc
    pden = torch.zeros(nsym * n_sc)
    pden[pilot_pos] = 1.0
    old = pden.reshape(nsym, n_sc).sum(dim=0)
    assert count.dtype == old.dtype and torch.equal(count, old)
    assert int(count.sum()) == pilot_pos.numel()


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(untraced output, traced output, the program's spans [(label, t0,
    t1)]) of one dd 1x2 trial at 6 PRB, CFI 2 (the smallest cell with a
    PDCCH), 2 rounds."""
    sim = dlsim.DlsimFading(dlsim.DlsimFadingConfig(
        mcs=4, n_rb=6, channel="EVA", n_rx=2, est_mode="dd",
        n_pdcch_symbols=2, batch=4, n_harq_rounds=2), device=DEV)
    snr = 10.0
    args = sim.draw(torch.Generator().manual_seed(5)) + (
        np.float32(10.0 ** (-snr / 10.0)), sim.wiener(snr),
        sim.err_var(snr))
    assert sim.pdcch_on
    plain = sim.trial(*args)
    d = tmp_path_factory.mktemp("trace_dd")
    with tracing.trace(str(d), device="cpu"):
        spanned = sim.trial(*args)
    (path,) = tracing.trace_artifacts(str(d))
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = [(e["name"][len(PREFIX):], e["ts"], e["ts"] + e["dur"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e["name"].startswith(PREFIX)]
    return plain, spanned, spans


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def test_dd_spans_open_once_a_round_and_nest(traced):
    _, _, spans = traced

    def inside(inner, outer):
        return (outer[1] <= inner[1] and inner[2] <= outer[2]
                and inner != outer)

    for label, parent in DD_PARENT.items():
        mine = [s for s in spans if s[0] == label]
        assert len(mine) == 2, label            # once a round
        for s in mine:
            holders = [o for o in spans if inside(s, o)]
            # the direct parent is the innermost span that holds it
            assert min(holders, key=lambda o: o[2] - o[1])[0] == parent
    estimate = [s for s in spans if s[0] == "estimate.dd"]
    for s in estimate:
        assert {o[0] for o in spans if inside(s, o)} \
            == {"frontend", "frontend.estimate"}
    kids = sorted((a, lab) for lab, a, _ in spans if lab.startswith("dd."))
    assert [lab for _, lab in kids] == ["dd.joint", "dd.decide",
                                        "dd.refine"] * 2


def test_dd_spans_leave_the_outputs_bit_for_bit(traced):
    plain, spanned, _ = traced
    a, b = _tensors(plain), _tensors(spanned)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
