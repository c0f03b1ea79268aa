"""Full-PHY mode of the PyTorch port's system emulator (sim/oaisim.py)
against the JAX package on the same draws: every UE receives the sum of
all eNBs' PDSCH subframes through its own links and decodes each eNB's
TB with that (eNB, UE)'s HARQ soft buffer.

The draws are the reference's own, replayed from its per-TTI keys split
in three ([0] the tap normals, [1] of the first E links the eNBs' fresh TB
bits, [2] of the first U links the UEs' noise normals; see
test_torch_oaisim.py). Every per-TTI error flag, every stats array, the
open TBs, summary() and the pcap bytes (the TB bytes of each scheduled
UE) must be equal, the soft buffers within 1e-3 of their scale; 6 PRB,
decoder window 96 on both sides."""
import numpy as np
import pytest
import torch

from test_torch_oaisim import _assert_equal_runs, _run_both

torch.set_num_threads(1)

# Full PHY: tests/test_oaisim.py's two-cell AWGN point and its HARQ soft-
# combining pair (over 2 frames, not its 4: the plain turbo decoder takes
# about 20 ms a half-iteration on the CPU), and 2 eNBs x 4 UEs on EPA over
# 2 frames with 4 HARQ rounds; points where blocks decode clearly or fail
# clearly (the two turbo decoders differ at the edge of a steep
# waterfall).
PHY = {
    "two cells AWGN": (dict(n_enb=2, n_ue=4, n_rb=6, mcs=0, tx_power_db=55.0,
                            mode="phy", channel="AWGN", speed_mps=0.0,
                            n_turbo_iter=4, seed=5), 2),
    "HARQ 1 round": (dict(n_enb=1, n_ue=2, n_rb=6, mcs=6, tx_power_db=22.0,
                          mode="phy", channel="AWGN", speed_mps=0.0,
                          n_turbo_iter=4, seed=12, n_harq_rounds=1), 2),
    "HARQ 4 rounds": (dict(n_enb=1, n_ue=2, n_rb=6, mcs=6, tx_power_db=22.0,
                           mode="phy", channel="AWGN", speed_mps=0.0,
                           n_turbo_iter=4, seed=12, n_harq_rounds=4), 2),
    "two cells EPA, 4 rounds": (dict(n_enb=2, n_ue=4, n_rb=6, mcs=4,
                                     tx_power_db=40.0, mode="phy",
                                     channel="EPA", speed_mps=0.0,
                                     n_turbo_iter=4, seed=2,
                                     n_harq_rounds=4), 2),
}


@pytest.mark.parametrize("case", list(PHY))
def test_full_phy_equals_reference(case, tmp_path):
    cfg, frames = PHY[case]
    runs = _run_both(cfg, frames, tmp_path, phy=True)
    jsim, sim, jflags, flags, jout, out, _ = runs
    _assert_equal_runs(*runs[:6], tmp_path)
    np.testing.assert_array_equal(sim._phy_tb.numpy(),
                                  np.asarray(jsim._phy_tb))
    np.testing.assert_array_equal(sim._phy_bound, jsim._phy_bound)
    for e in range(cfg["n_enb"]):
        for w, jw in zip(sim._phy_wsoft[e], jsim._phy_wsoft[e]):
            jw = np.asarray(jw)
            scale = max(float(np.abs(jw).max()), 1.0)
            assert float(np.abs(w.numpy() - jw).max()) <= 1e-3 * scale
    if "4 rounds" in case:
        assert out["retx_total"] > 0
    if case == "two cells AWGN":
        assert out["mean_bler"] < 0.5
