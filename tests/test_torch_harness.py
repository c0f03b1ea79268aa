"""The sweep harness of the PyTorch port against the JAX package's: the same
CSV bytes for the same rows, the same checkpoint file and resume, the same
sweep rows from one stub simulator; and the port's dlsim command line
routed to each simulator with --device cpu at 6 PRB."""
import dataclasses

import numpy as np
import pytest
import torch

from openair4g_tpu.sim import harness as jh
from openair4g_tpu_torch.sim import harness as h

torch.set_num_threads(1)

ROWS = [(-2.0, np.array([10, 3]), np.array([100, 10]), np.array([0.1, 0.3])),
        (0.5, np.array([0, 0]), np.array([128, 0]), np.array([0.0, 0.0])),
        (13.25, np.array([7]), np.array([2048]), np.array([7 / 2048]))]


def test_csv_bytes_equal_reference(tmp_path):
    got, want = tmp_path / "port.csv", tmp_path / "jax.csv"
    h.write_bler_csv(str(got), ROWS, mcs=5, tbs=2216, rate=0.3, dci_err=4)
    jh.write_bler_csv(str(want), ROWS, mcs=5, tbs=2216, rate=0.3, dci_err=4)
    assert got.read_bytes() == want.read_bytes()
    assert got.read_text().splitlines()[0].split(";") == [
        "-2", "5", "2216", "0.300000", "10", "100", "3", "10", "4"]


def test_sweep_state_resumes_and_drops_a_stale_checkpoint(tmp_path):
    path = str(tmp_path / "ck.json")
    st = h.SweepState(config={"mcs": 4}, seed=1)
    st.update(-2.0, [5, 1], [64, 5], 2)
    st.save(path)
    point = {"errs": [5, 1], "trials": [64, 5], "streams": 2}
    assert h.SweepState.load(path, {"mcs": 4}, seed=1).get(-2.0) == point
    # the reference reads the port's file, and the other way round
    assert jh.SweepState.load(path, {"mcs": 4}, seed=1).get(-2.0) == point
    assert h.SweepState.load(path, {"mcs": 5}, seed=1).get(-2.0) is None
    assert h.SweepState.load(path, {"mcs": 4}, seed=2).get(-2.0) is None


@dataclasses.dataclass(frozen=True)
class _Cfg:
    batch: int = 8
    mcs: int = 4


class StubSim:
    """Per-round error counts that fall with SNR and reach 0 at 2 dB."""
    cfg = _Cfg()

    def __init__(self):
        self.calls = []

    def run_snr(self, s, n, seed):
        self.calls.append(s)
        e0 = max(0, int(4 - 2 * s))
        return np.array([e0, e0 // 2]), np.array([n, e0])


def test_resumable_sweep_rows_equal_reference(tmp_path):
    snrs = [-1.0, 0.0, 1.0, 2.0, 3.0]
    kw = dict(verbose=False, seed=3)
    port, ref = StubSim(), StubSim()
    rows = h.resumable_sweep(port, snrs, 16, **kw)
    want = jh.resumable_sweep(ref, snrs, 16, **kw)
    assert port.calls == ref.calls == [-1.0, 0.0, 1.0, 2.0]    # early exit
    assert len(rows) == len(want)
    for got, w in zip(rows, want):
        assert got[0] == w[0]
        for a, b in zip(got[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
    # resume: a second sweep over the same checkpoint runs nothing again
    path = str(tmp_path / "ck.json")
    sim = StubSim()
    h.resumable_sweep(sim, snrs, 16, ckpt_path=path, early_exit=False, **kw)
    sim.calls.clear()
    again = h.resumable_sweep(sim, snrs, 16, ckpt_path=path,
                              early_exit=False, **kw)
    assert sim.calls == [] and len(again) == len(snrs)


@pytest.mark.parametrize("argv,sim_name,n_cols", [
    (["-x", "1", "-g", "AWGN"], "DlsimAwgn", 1),        # round 0
    (["-x", "1", "-g", "EVA", "-r", "2"], "DlsimFading", 2),  # two rounds
    (["-x", "2"], "DlsimTxDiv", 1),
    (["-x", "3"], "DlsimSm", 2),                         # two codewords
])
def test_dlsim_cli_routes_each_mode_on_the_cpu(tmp_path, monkeypatch, argv,
                                               sim_name, n_cols):
    sims = []

    def spy(sim, *a, **k):
        sims.append(sim)
        return sweep(sim, *a, **k)
    sweep = h.resumable_sweep
    monkeypatch.setattr(h, "resumable_sweep", spy)
    csv = tmp_path / "out.csv"
    rows = h.dlsim_main(argv + ["--device", "cpu", "-m", "4", "-B", "6",
                                "-s", "20", "-S", "20", "-n", "4", "-b", "4",
                                "-t", "2", "-o", str(csv)])
    assert [type(s).__name__ for s in sims] == [sim_name]
    assert sims[0].device == torch.device("cpu")
    assert len(rows) == 1 and len(rows[0][1]) == n_cols
    cols = csv.read_text().strip().split(";")
    assert cols[:3] == ["20", "4", "408"] and len(cols) == 4 + 2 * n_cols + 1
    assert int(cols[5]) == 4                 # trials of round 0


def test_dlsim_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        h.dlsim_main(["--device", "cuda", "-B", "6", "-n", "4"])
    assert e.value.code not in (0, None)
