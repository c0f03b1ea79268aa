"""Ulsim.trial of the PyTorch port against the JAX simulator's jitted
`_trial_step` on replayed key splits (test_torch_ulsim.py) in the channel
modes: type-1 and type-2 PUSCH frequency hopping with the configurations
of tests/test_srs_hopping_pc.py (a per-slot channel at two bin sets, the
estimator's step weights), the time-domain FIR channel on EVA over 2 HARQ
rounds, and the genie channel with hopping. Batch 8, 4 turbo iterations,
decoder window 96 on both sides. At 30 dB and at an SNR where round 0
fails for part of the batch the per-round errs and reach must be equal."""
import pytest
import torch

from test_torch_ulsim import B, check_equal, make_pair, run_both

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

# mode: (config, (moderate SNR in dB, seed))
MODES = {
    "hopping_type1_eva": (dict(mcs=10, n_rb=25, n_rb_alloc=6, rb_offset=2,
                               channel="EVA", hopping_bits=0), (2.0, 2)),
    "hopping_type2_awgn": (dict(mcs=10, n_rb=25, n_rb_alloc=4, rb_offset=3,
                                channel="AWGN", hopping_bits=1, n_sb=2,
                                n_rb_ho=1), (3.0, 1)),
    "time_domain_eva_2_rounds": (dict(mcs=10, n_rb=6, n_rb_alloc=6,
                                      channel="EVA",
                                      time_domain_channel=True,
                                      n_harq_rounds=2), (4.0, 3)),
    "perfect_ce_hopping_eva": (dict(mcs=10, n_rb=25, n_rb_alloc=6,
                                    rb_offset=2, channel="EVA",
                                    hopping_bits=0, perfect_ce=True),
                               (2.0, 2)),
}


@pytest.fixture(scope="module", params=sorted(MODES))
def pair(request):
    cfg, point = MODES[request.param]
    return (request.param, point) + make_pair(cfg)


def test_counts_equal_reference_at_high_snr(pair):
    _, _, jsim, sim = pair
    want, got = run_both(jsim, sim, 30.0, seed=0)
    check_equal(want, got)
    R = jsim.cfg.n_harq_rounds
    assert got.errs.tolist() == [0] * R
    assert got.reach.tolist() == [B] + [0] * (R - 1)


def test_counts_equal_reference_at_moderate_snr(pair):
    mode, (snr, seed), jsim, sim = pair
    assert sim.pm.hopped == mode.startswith(("hopping", "perfect"))
    want, got = run_both(jsim, sim, snr, seed)
    check_equal(want, got)
    assert 0 < got.errs[0] < B, got.errs
