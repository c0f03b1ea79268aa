"""The SISO fidelity anchors of tests/test_bler_anchor.py and
tests/test_fading.py, run through the PyTorch port's DlsimFading on the
CPU with the reference tests' configurations, trial counts and bands (the
operating points and their margins are the reference's; VALIDATION.md).
The port draws from torch.Generator streams, not the reference's keys, so
each count is another sample of the same binomial, inside the same band.

Tests that take more than about 15 s on one CPU core are marked slow;
chip_smoke.py phase 14 holds every one of them on the card."""
import numpy as np
import pytest
import torch

from openair4g_tpu_torch.phy.channel_est import pdp_prior
from openair4g_tpu_torch.sim.channels import PROFILES
from openair4g_tpu_torch.sim.dlsim import DlsimFading, DlsimFadingConfig

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)


def _sim(**cfg):
    return DlsimFading(DlsimFadingConfig(**cfg), device="cpu")


def test_mcs4_estimated_ce_waterfall_location():
    """Estimated-CE AWGN waterfall of MCS 4 at 25 PRB: knee at -1.8 dB."""
    sim = _sim(mcs=4, n_rb=25, channel="AWGN", batch=128, n_turbo_iter=8,
               n_harq_rounds=1)
    errs, reach = sim.run_snr(-2.6, 256)
    assert errs[0] >= reach[0] * 0.9, (errs, reach)
    errs, reach = sim.run_snr(-1.8, 256)
    assert reach[0] * 0.2 <= errs[0] <= reach[0] * 0.8, (errs, reach)
    errs, reach = sim.run_snr(-1.0, 256)
    assert errs[0] <= reach[0] * 0.1, (errs, reach)


def test_mcs4_perfect_ce_beats_reference_anchor():
    sim = _sim(mcs=4, n_rb=25, channel="AWGN", batch=128, n_turbo_iter=8,
               n_harq_rounds=1, perfect_ce=True)
    errs, reach = sim.run_snr(0.6, 256)    # reference < 0.1 here
    assert errs[0] == 0, (errs, reach)


def test_eva_1x2_corpus_test5_anchor():
    """Corpus test 5 conditions (1.4 MHz MCS 4 EVA 1x2 MRC, dlsim SNR
    convention): round-0 BLER in [0.05, 0.37] (reference 0.325) and a HARQ
    gain."""
    sim = _sim(mcs=4, n_rb=6, channel="EVA", n_pdcch_symbols=3, n_rx=2,
               n_harq_rounds=2, batch=128, snr_convention="dlsim",
               est_mode="joint")
    errs, reach = sim.run_snr(-1.6, 256)
    assert 0.05 <= errs[0] / reach[0] <= 0.37, (errs, reach)
    assert errs[1] < errs[0]


def test_etu_harq_gain_ordering():
    """ETU 1x2 with fresh fades per round: each round's conditional BLER
    falls (reference r0 1.0 -> r1 0.94 -> r2 0.26 -> r3 0.03)."""
    sim = _sim(mcs=10, n_rb=6, channel="ETU", n_pdcch_symbols=3, n_rx=2,
               n_harq_rounds=4, batch=128, snr_convention="dlsim",
               est_mode="joint")
    errs, reach = sim.run_snr(-4.0, 256)
    bler = errs / np.maximum(reach, 1)
    assert bler[0] > 0.6, bler
    assert bler[1] < bler[0] and bler[2] < bler[1], bler
    assert errs[3] <= errs[2]


LADDER = [(2, -4.4, -4.0, -3.4), (9, 1.7, 2.0, 2.3), (13, 4.7, 5.0, 5.3),
          (17, 8.1, 8.4, 8.8), (21, 10.9, 11.2, 11.6),
          (27, 15.5, 15.8, 16.3)]
SLOW_LADDER = {13, 17, 21, 27}


@pytest.mark.parametrize("mcs,lo,mid,hi", [
    pytest.param(*row, marks=pytest.mark.slow) if row[0] in SLOW_LADDER
    else row for row in LADDER])
def test_awgn_ladder_anchor(mcs, lo, mid, hi):
    """AWGN MCS ladder (awgn_campaign.json): 25 PRB, 1 PDCCH symbol,
    interp estimation, dlsim SNR convention; below, at and above the
    knee with 256-trial margins."""
    sim = _sim(mcs=mcs, n_rb=25, channel="AWGN", n_pdcch_symbols=1, n_rx=1,
               n_harq_rounds=1, batch=128, est_mode="interp",
               snr_convention="dlsim")
    errs, reach = sim.run_snr(lo, 256)
    assert errs[0] >= reach[0] * 0.8, ("below-knee", errs, reach)
    errs, reach = sim.run_snr(mid, 256)
    assert reach[0] * 0.15 <= errs[0] <= reach[0] * 0.85, \
        ("mid-knee", errs, reach)
    errs, reach = sim.run_snr(hi, 256)
    assert errs[0] <= reach[0] * 0.12, ("above-knee", errs, reach)


def test_fading_harq_gain():
    """EVA MCS 10 at 6 PRB, 3 rounds: HARQ rounds reduce BLER."""
    sim = _sim(mcs=10, n_rb=6, channel="EVA", batch=32, n_turbo_iter=4,
               n_harq_rounds=3)
    errs, reach = sim.run_snr(6.0, 64)
    bler = errs / np.maximum(reach, 1)
    assert reach[0] == 64
    assert bler[1] < bler[0]
    assert bler[2] <= bler[1] + 0.1 or errs[-1] <= 1


def test_measured_delay_prior_tracks_pdp():
    """The adaptive prior, measured from received pilots with no channel
    knowledge, recovers EVA's delay-power profile (compressed by 0.651)
    within a few percent of probability mass, and the sim runs with it."""
    sim = _sim(mcs=15, n_rb=25, channel="EVA", n_pdcch_symbols=3, n_rx=2,
               n_harq_rounds=1, batch=16, delay_scale=0.651,
               est_mode="joint", snr_convention="dlsim",
               est_prior="adaptive")
    pm = sim._measure_prior(10.0, n_probe=64)
    d, a = PROFILES["EVA"]
    pg = pdp_prior(sim.fp, d, 10.0 ** (0.1 * np.asarray(a)), 0.651)
    assert abs(pm[:10].sum() - pg[:10].sum()) < 0.05, (pm[:10], pg[:10])
    assert pm[0] > 0.3
    errs, reach = sim.run_snr(10.0, 16)
    assert reach[0] == 16


@pytest.mark.slow
def test_dd_corpus_anchor():
    """The corpus receiver (dd) at a test-11-shaped point: 10 MHz MCS 26
    EVA 1x2, 14.6 dB, dlsim convention: round-0 BLER at most the
    reference's 0.337 plus 3 sigma of 256 trials."""
    sim = _sim(mcs=26, n_rb=50, channel="EVA", n_pdcch_symbols=2, n_rx=2,
               n_harq_rounds=1, batch=128, snr_convention="dlsim",
               n_turbo_iter=8, est_mode="dd")
    errs, reach = sim.run_snr(14.6, 256)
    assert errs[0] / max(reach[0], 1) <= 0.337 + 0.09, (errs, reach)
