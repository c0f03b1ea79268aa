"""The fidelity configurations 2-4 of BASELINE.json: PUSCH 16QAM, 2x2
TxDiv 64QAM and the 20 MHz full chain with HARQ (counterpart of
scripts/fidelity_campaign.py).

The reference ships no ULSCH, TxDiv or 20 MHz BLER corpus, so these runs
are the framework's own curves: each waterfall sits within about 2 dB of
the DL AWGN anchor of the same spectral efficiency (BASELINE.md), and
the 2x2 TxDiv curve shows the diversity slope.

    python3 -m openair4g_tpu_torch.scripts.fidelity_campaign [n_trials]
        [out.json] [only] [--snrs A,B] [--device cuda] [--out-dir DIR]

--snrs replaces the SNR list of ulsim16 and txdiv64 and the point of
harq20mhz. Each configuration is written to DIR/<name>.json (resume: one
whose file exists is skipped), then all of them to out.json (default
DIR/fidelity_campaign.json), in the schema of the repo's
fidelity_campaign.json plus "device" and "seconds".
"""
from __future__ import annotations

import numpy as np

from ..sim.dlsim import DlsimFading, DlsimFadingConfig
from ..sim.dlsim_mimo import DlsimTxDiv, DlsimTxDivConfig
from ..sim.ulsim import Ulsim, UlsimConfig
from . import common

CONFIGS = ["ulsim16", "txdiv64", "harq20mhz"]
SNRS = {"ulsim16": [3.0, 3.5, 4.0, 4.5, 5.0, 5.5, 6.0],
        "txdiv64": [12.0, 13.0, 14.0, 15.0, 16.0, 17.0, 18.0],
        "harq20mhz": [4.6]}


def _rows(rows) -> list:
    return [[r[0], int(r[1][0]), int(r[2][0]), float(r[3][0])] for r in rows]


def run_ulsim16(n_trials: int, snrs, dev) -> dict:
    # 5 MHz PUSCH 16QAM (MCS 10, TBS 4008 at 25 PRB), AWGN, the DMRS
    # estimate; the DL MCS 10 anchor's counterpart (SNR@10% = 5.3 dB with
    # the reference's Q15 RX).
    sim = Ulsim(UlsimConfig(mcs=10, n_rb=25, n_rb_alloc=25, channel="AWGN",
                            batch=256, n_harq_rounds=1), device=dev)
    return {"desc": "5MHz PUSCH 16QAM MCS10 AWGN estimated-CE round-0",
            "rows": _rows(sim.sweep(snrs, n_trials)),
            "dl_awgn_counterpart_snr_at_10pct": 5.3}


def run_txdiv64(n_trials: int, snrs, dev) -> dict:
    # 10 MHz 2x2 TxDiv (TM2 SFBC) 64QAM MCS 25, EVA, the per-port estimate
    # and Alamouti/MRC combining.
    sim = DlsimTxDiv(DlsimTxDivConfig(mcs=25, n_rb=50, n_rx=2, channel="EVA",
                                      batch=128), device=dev)
    return {"desc": "10MHz 2x2 TxDiv SFBC 64QAM MCS25 EVA estimated-CE "
                    "round-0",
            "rows": _rows(sim.sweep(snrs, n_trials))}


def run_harq20mhz(n_trials: int, snrs, dev) -> dict:
    # 20 MHz full chain (100 PRB MCS 15 16QAM), EVA, 4 HARQ rounds with rv
    # cycling, the joint estimate.
    sim = DlsimFading(DlsimFadingConfig(
        mcs=15, n_rb=100, channel="EVA", n_rx=2, n_harq_rounds=4,
        batch=64, snr_convention="dlsim", est_mode="joint"), device=dev)
    errs, reach = sim.run_snr(snrs[0], n_trials)
    return {"desc": f"20MHz MCS15 EVA 1x2 4-round HARQ @ {snrs[0]} dB "
                    "(test6 config scaled to 100 PRB)",
            "errs": errs.tolist(), "reached": reach.tolist(),
            "bler": (errs / np.maximum(reach, 1)).tolist()}


RUN = {"ulsim16": run_ulsim16, "txdiv64": run_txdiv64,
       "harq20mhz": run_harq20mhz}


def main(argv=None) -> dict:
    p = common.parser("fidelity_campaign", __doc__)
    p.add_argument("n_trials", nargs="?", type=int, default=1024)
    p.add_argument("out", nargs="?", default=None)
    p.add_argument("only", nargs="?", default=None)
    p.add_argument("--snrs", default=None,
                   help="comma-separated SNRs (dB) instead of the config's")
    a = p.parse_args(argv)
    dev, out, card = common.setup("fidelity_campaign", a)
    snrs = common.snr_list(a.snrs)
    names = [n for n in CONFIGS if a.only in (None, n)]
    if not names:
        p.error(f"no configuration {a.only!r}")
    common.run_each(
        names, out, lambda n: RUN[n](a.n_trials, snrs or SNRS[n], dev), card)
    path = common.out_path(out, a.out, "fidelity_campaign.json")
    results = common.collect(CONFIGS, out)
    common.write_json(path, results)
    print("wrote", path, flush=True)
    return results


if __name__ == "__main__":
    main()
