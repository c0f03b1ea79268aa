"""Fading/HARQ BLER campaign at the corpus operating points
(counterpart of scripts/fading_campaign.py).

The points of the reference's dlsim corpus
(openair1/SIMULATION/LTE_PHY/REFERENCE_DATA/pdsch.txt) with each test's
configuration: 1 TX / 2 RX MRC, estimated channel (--est-mode, "dd" by
default: the joint 2D-LMMSE pass with the decision-directed refinement;
"joint" is the first pass alone), 4 HARQ rounds with rv cycling, a fresh
channel every round, EVA / ETU, the dlsim SNR convention.

    python3 -m openair4g_tpu_torch.scripts.fading_campaign [n_trials]
        [out.json] [only] [--est-mode dd] [--device cuda] [--out-dir DIR]

Each point is written to DIR/<test>.json (resume: a point whose file
exists is skipped), then all of them to out.json (default
DIR/fading_campaign.json), in the schema of the repo's
fading_campaign.json plus "device" and "seconds".
"""
from __future__ import annotations

import numpy as np

from ..sim.dlsim import DlsimFading, DlsimFadingConfig
from . import common

# (name, mcs, n_rb, n_pdcch, channel, snr_db, reference per-round BLER)
CORPUS = [
    ("test1",  5, 50, 2, "EVA", -2.8, (0.353, 0.034, 0.333, 0.0)),
    ("test5",  4,  6, 3, "EVA", -1.6, (0.325, 0.134, 0.0, None)),
    ("test6", 15, 50, 2, "EVA",  4.6, (0.409, 0.0097, 0.0, None)),
    ("test6b", 14, 25, 3, "EVA", 4.8, (0.381, 0.0, None, None)),
    ("test7", 15, 50, 2, "ETU", -1.0, (1.0, 0.937, 0.258, 0.033)),
    ("test7b", 14, 25, 3, "ETU", -1.0, (0.996, 0.896, 0.298, 0.060)),
    ("test10", 25, 25, 3, "EVA", 13.8, (0.421, 0.0, None, None)),
    ("test11", 26, 50, 2, "EVA", 14.6, (0.337, 0.0, None, None)),
]


def run_point(name: str, n_trials: int, est_mode: str, dev) -> dict:
    _, mcs, n_rb, c, chan, snr, ref = next(p for p in CORPUS
                                           if p[0] == name)
    sim = DlsimFading(DlsimFadingConfig(
        mcs=mcs, n_rb=n_rb, channel=chan, n_pdcch_symbols=c, n_rx=2,
        n_harq_rounds=4, batch=128 if n_rb == 50 else 256,
        snr_convention="dlsim", est_mode=est_mode), device=dev)
    errs, reach = sim.run_snr(snr, n_trials)
    bler = (errs / np.maximum(reach, 1)).tolist()
    print(f"{name}: SNR {snr:+.1f} {chan} mcs{mcs} B{n_rb}  "
          f"bler={['%.3f' % b for b in bler]}  ref={ref}", flush=True)
    return {"est_mode": est_mode, "mcs": mcs, "n_rb": n_rb, "channel": chan,
            "snr_db": snr, "errs": errs.tolist(), "reached": reach.tolist(),
            "bler": bler, "ref_bler": list(ref)}


def main(argv=None) -> dict:
    p = common.parser("fading_campaign", __doc__)
    p.add_argument("n_trials", nargs="?", type=int, default=2048)
    p.add_argument("out", nargs="?", default=None)
    p.add_argument("only", nargs="?", default=None)
    p.add_argument("--est-mode", default="dd",
                   choices=("dd", "joint", "interp"))
    a = p.parse_args(argv)
    dev, out, card = common.setup("fading_campaign", a)
    names = [n for n, *_ in CORPUS if a.only in (None, n)]
    if not names:
        p.error(f"no corpus point {a.only!r}")
    common.run_each(
        names, out, lambda n: run_point(n, a.n_trials, a.est_mode, dev),
        card)
    path = common.out_path(out, a.out, "fading_campaign.json")
    results = common.collect([n for n, *_ in CORPUS], out)
    common.write_json(path, results)
    print("wrote", path, flush=True)
    return results


if __name__ == "__main__":
    main()
