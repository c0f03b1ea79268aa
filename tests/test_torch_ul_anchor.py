"""The uplink anchors of tests/test_bler_anchor.py (the ladder rows of
ulsim_campaign.json: 25 PRB, estimated DMRS channel, MCS 4 and 16 on AWGN,
MCS 10 on EVA through the time-domain FIR channel) and the Monte-Carlo
checks of tests/test_ulsim.py and tests/test_uci.py, run through the
PyTorch port's Ulsim on the CPU with the reference tests' configurations,
trial counts and bands. The port draws from torch.Generator streams, not
the reference's keys, so each count is another sample of the same
binomial, inside the same band.

The ladder rows that take more than about 15 s on one CPU core are marked
slow; chip_smoke.py holds all three on the card."""
import pytest
import torch

from openair4g_tpu_torch.ops.uci import UciConfig
from openair4g_tpu_torch.sim.ulsim import Ulsim, UlsimConfig

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)


def _sim(**cfg):
    return Ulsim(UlsimConfig(**cfg), device="cpu")


@pytest.mark.parametrize("mcs,channel,tdc,lo,mid,hi", [
    (4, "AWGN", False, -2.6, -1.8, -1.0),
    pytest.param(16, "AWGN", False, 7.0, 7.6, 8.3, marks=pytest.mark.slow),
    pytest.param(10, "EVA", True, 2.0, 7.5, 14.5, marks=pytest.mark.slow),
])
def test_ul_ladder_anchor(mcs, channel, tdc, lo, mid, hi):
    """Below, at and above the knee with the reference's 128-trial
    margins."""
    sim = _sim(mcs=mcs, n_rb=25, n_rb_alloc=25, channel=channel, batch=128,
               time_domain_channel=tdc)
    errs, reach = sim.run_snr(lo, 128)
    assert errs[0] >= reach[0] * 0.7, ("below-knee", errs, reach)
    errs, reach = sim.run_snr(mid, 128)
    assert reach[0] * 0.1 <= errs[0] <= reach[0] * 0.9, \
        ("mid-knee", errs, reach)
    errs, reach = sim.run_snr(hi, 128)
    assert errs[0] <= reach[0] * 0.13, ("above-knee", errs, reach)


def test_ulsim_awgn_high_snr_perfect():
    sim = _sim(mcs=16, n_rb=25, n_rb_alloc=25, channel="AWGN", batch=8,
               n_harq_rounds=1)
    errs, reach = sim.run_snr(25.0, 8)
    assert errs[0] == 0 and reach[0] == 8


def test_ulsim_waterfall_monotone():
    """BLER falls with SNR through the waterfall (QPSK MCS 6, AWGN)."""
    sim = _sim(mcs=6, n_rb=25, n_rb_alloc=25, channel="AWGN", batch=64,
               n_harq_rounds=1, n_turbo_iter=6)
    blers = []
    for snr in (-1.0, 1.5, 4.0):
        errs, reach = sim.run_snr(snr, 64)
        blers.append(errs[0] / reach[0])
    assert blers[0] > 0.9, blers
    assert blers[-1] < 0.1, blers


def test_ulsim_harq_gain():
    """Where round 0 mostly fails, chase combining over rv 0, 1, 2 rescues
    most trials by round 2."""
    sim = _sim(mcs=16, n_rb=25, n_rb_alloc=25, channel="AWGN", batch=64,
               n_harq_rounds=3, n_turbo_iter=6)
    errs, reach = sim.run_snr(6.0, 64)
    assert errs[0] > 0.5 * reach[0]
    assert errs[2] < 0.2 * reach[0]


def test_ulsim_time_fir_channel_decodes():
    sim = _sim(mcs=10, n_rb=25, channel="EVA", batch=16, n_turbo_iter=4,
               time_domain_channel=True)
    errs, reach = sim.run_snr(18.0, 16)
    assert errs[0] <= 1, (errs, reach)


def test_ulsim_with_uci_awgn():
    """16QAM PUSCH with CQI, RI and ACK at its operating SNR: data decodes
    and each UCI field fails on at most 3 of 64 trials."""
    sim = _sim(mcs=12, n_rb=6, n_rb_alloc=6, channel="AWGN", batch=32,
               n_turbo_iter=6, uci=UciConfig(o_cqi=8, o_ri=1, o_ack=2))
    errs, reach = sim.run_snr(14.0, 64)
    assert errs[0] <= reach[0] * 0.1, (errs, reach)
    assert (sim.uci_errs <= 3).all(), sim.uci_errs


def test_ulsim_uci_does_not_break_data_only():
    sim = _sim(mcs=6, n_rb=6, n_rb_alloc=6, channel="AWGN", batch=32,
               n_turbo_iter=6)
    errs, reach = sim.run_snr(10.0, 32)
    assert errs[0] == 0, (errs, reach)
