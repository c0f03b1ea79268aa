"""The EVA round-0 BLER ablation (counterpart of scripts/eva_ablation.py).

Hypothesis: the reference's random_channel.c:988 places tap l at FIR
sample delays[l] * BW with BW the nominal bandwidth in MHz (dlsim.c:
684-703: 1.25/5/10/20) while the signal is sampled at ofdm_symbol_size x
15 kHz, so its corpus was made with every tap delay compressed by BW/f_s
= 0.651: a flatter channel than true 36.101 EVA/ETU. The cases rerun the
corpus round-0 points with delay_scale 0.651 (and the true 1.0), then
perfect CE, the delay prior, the estimator, one RX chain, the error
variance and SNR offsets on tests 6 and 10, to tell estimation loss from
channel statistics.

    python3 -m openair4g_tpu_torch.scripts.eva_ablation [n_trials]
        [out.json] [only_case] [--device cuda] [--out-dir DIR]

Each case is written to DIR/<case>.json (resume: one whose file exists
is skipped), then all of them to out.json (default
DIR/eva_ablation.json), in the schema of the repo's eva_ablation.json
plus "device" ("seconds" it had).
"""
from __future__ import annotations

from ..sim.dlsim import DlsimFading, DlsimFadingConfig
from . import common

REF_SCALE = 0.6510416667          # BW/f_s, identical at all LTE bandwidths

# (case, mcs, n_rb, n_pdcch, channel, snr_db, delay_scale, perfect_ce,
#  reference round-0 BLER, extra-config dict)
CASES = [
    ("test1_ref",  5, 50, 2, "EVA", -2.8, REF_SCALE, False, 0.353, {}),
    ("test6_ref", 15, 50, 2, "EVA",  4.6, REF_SCALE, False, 0.409, {}),
    ("test6b_ref", 14, 25, 3, "EVA", 4.8, REF_SCALE, False, 0.381, {}),
    ("test10_ref", 25, 25, 3, "EVA", 13.8, REF_SCALE, False, 0.421, {}),
    ("test11_ref", 26, 50, 2, "EVA", 14.6, REF_SCALE, False, 0.337, {}),
    ("test7_ref", 15, 50, 2, "ETU", -1.0, REF_SCALE, False, 1.0, {}),
    # E1: estimation loss removed entirely
    ("test6_ref_pce", 15, 50, 2, "EVA", 4.6, REF_SCALE, True, None, {}),
    # E2: genie delay prior (estimator matched to the compressed PDP)
    ("test6_ref_pdp", 15, 50, 2, "EVA", 4.6, REF_SCALE, False, None,
     dict(est_prior="pdp")),
    # E2b: measured prior (receiver-side delay-spread estimation)
    ("test6_ref_adaptive", 15, 50, 2, "EVA", 4.6, REF_SCALE, False, None,
     dict(est_prior="adaptive")),
    ("test10_ref_adaptive", 25, 25, 3, "EVA", 13.8, REF_SCALE, False,
     None, dict(est_prior="adaptive")),
    # E3: per-pilot-symbol interp estimator (the reference's mode analog)
    ("test6_ref_interp", 15, 50, 2, "EVA", 4.6, REF_SCALE, False, None,
     dict(est_mode="interp")),
    # E5: single RX chain (MRC out of the loop)
    ("test6_ref_1rx", 15, 50, 2, "EVA", 4.6, REF_SCALE, False, None,
     dict(n_rx=1)),
    # E6: estimation-error variance not fed to the LLR noise term
    ("test6_ref_noev", 15, 50, 2, "EVA", 4.6, REF_SCALE, False, None,
     dict(use_est_err_var=False)),
    # E4: SNR offsets around the operating point
    ("test6_ref_p05", 15, 50, 2, "EVA", 5.1, REF_SCALE, False, None, {}),
    ("test6_ref_p10", 15, 50, 2, "EVA", 5.6, REF_SCALE, False, None, {}),
    # the same discriminators on the 64QAM outlier (test 10)
    ("test10_ref_pce", 25, 25, 3, "EVA", 13.8, REF_SCALE, True, None, {}),
    ("test10_ref_pdp", 25, 25, 3, "EVA", 13.8, REF_SCALE, False, None,
     dict(est_prior="pdp")),
    ("test10_ref_p05", 25, 25, 3, "EVA", 14.3, REF_SCALE, False, None, {}),
    # estimation-loss split under true channel statistics
    ("test6_true_pce", 15, 50, 2, "EVA", 4.6, 1.0, True, None, {}),
    # true-delay controls (should reproduce fading_campaign.json)
    ("test6_true", 15, 50, 2, "EVA", 4.6, 1.0, False, None, {}),
    ("test1_true", 5, 50, 2, "EVA", -2.8, 1.0, False, None, {}),
]


def run_case(name: str, n_trials: int, dev) -> dict:
    _, mcs, n_rb, c, chan, snr, scale, pce, ref, extra = next(
        k for k in CASES if k[0] == name)
    kw = dict(n_rx=2, est_mode="joint")
    kw.update(extra)
    sim = DlsimFading(DlsimFadingConfig(
        mcs=mcs, n_rb=n_rb, channel=chan, n_pdcch_symbols=c,
        n_harq_rounds=1, batch=128 if n_rb == 50 else 256,
        delay_scale=scale, perfect_ce=pce, snr_convention="dlsim", **kw),
        device=dev)
    errs, reach = sim.run_snr(snr, n_trials)
    bler = float(errs[0] / max(reach[0], 1))
    print(f"{name}: bler={bler:.3f} ref={ref}", flush=True)
    return dict(mcs=mcs, n_rb=n_rb, channel=chan, snr_db=snr,
                delay_scale=scale, perfect_ce=pce, errs=int(errs[0]),
                trials=int(reach[0]), bler=bler, ref_bler=ref, extra=extra)


def main(argv=None) -> dict:
    p = common.parser("eva_ablation", __doc__)
    p.add_argument("n_trials", nargs="?", type=int, default=1024)
    p.add_argument("out", nargs="?", default=None)
    p.add_argument("only", nargs="?", default=None)
    a = p.parse_args(argv)
    dev, out, card = common.setup("eva_ablation", a)
    names = [n for n, *_ in CASES if a.only in (None, n)]
    if not names:
        p.error(f"no case {a.only!r}")
    common.run_each(names, out, lambda n: run_case(n, a.n_trials, dev),
                    card)
    results = common.collect([n for n, *_ in CASES], out)
    path = common.out_path(out, a.out, "eva_ablation.json")
    common.write_json(path, results)
    print("wrote", path, flush=True)
    return results


if __name__ == "__main__":
    main()
