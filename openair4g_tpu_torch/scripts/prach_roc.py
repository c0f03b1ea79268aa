"""The PRACH detection-threshold ROC (counterpart of scripts/prach_roc.py).

Sweeps the normalized-peak threshold over noise-only occasions (per
threshold: the false alarms of any preamble an occasion) against the
detection rate at the link-budget SNR, for four configurations; the
operating point is the least threshold with under 1e-3 false alarms an
occasion (phy/prach.py's default threshold rests on it).

    python3 -m openair4g_tpu_torch.scripts.prach_roc [n_batches] [out.json]
        [only] [--device cuda] [--out-dir DIR]

Each configuration is written to DIR/<name>.json (resume: one whose file
exists is skipped), then all of them to out.json (default
DIR/prach_roc.json), in the schema of the repo's prach_roc.json plus
"device" and "seconds".
"""
from __future__ import annotations

import numpy as np

from ..sim.prachsim import Prachsim, PrachsimConfig
from . import common

THRESHOLDS = np.arange(6.0, 30.0, 1.0)
FA_LIMIT = 1e-3
# (name, PrachsimConfig fields, SNR dB)
CONFIGS = [
    ("fmt0_ncs13", dict(batch=256), -6.0),
    ("fmt0_ncs13_lowsnr", dict(batch=256), -12.0),
    ("restricted_ncs15", dict(root_u=500, ncs=15, high_speed=True,
                              max_delay=10, batch=256), -6.0),
    ("fmt4_ncs15", dict(root_u=3, ncs=15, fmt=4, max_delay=6, batch=256),
     -6.0),
]


def run_config(name: str, n_batches: int, dev) -> dict:
    _, fields, snr = next(c for c in CONFIGS if c[0] == name)
    cfg = PrachsimConfig(**fields)
    rows = Prachsim(cfg, device=dev).roc(snr, THRESHOLDS,
                                         n_batches=n_batches)
    ok = [r for r in rows if r["fa_per_occasion"] < FA_LIMIT]
    op = ok[0] if ok else rows[-1]
    print(f"{name}: th*={op['threshold']} det={op['det_rate']:.4f} "
          f"fa={op['fa_per_occasion']:.2e} ({n_batches * cfg.batch} "
          "occasions)", flush=True)
    return dict(snr_db=snr, rows=rows, operating_point=op,
                occasions=n_batches * cfg.batch)


def main(argv=None) -> dict:
    p = common.parser("prach_roc", __doc__)
    p.add_argument("n_batches", nargs="?", type=int, default=64)
    p.add_argument("out", nargs="?", default=None)
    p.add_argument("only", nargs="?", default=None)
    a = p.parse_args(argv)
    dev, out, card = common.setup("prach_roc", a)
    names = [n for n, *_ in CONFIGS if a.only in (None, n)]
    if not names:
        p.error(f"no configuration {a.only!r}")
    common.run_each(
        names, out, lambda n: run_config(n, a.n_batches, dev), card)
    path = common.out_path(out, a.out, "prach_roc.json")
    results = common.collect([n for n, *_ in CONFIGS], out)
    common.write_json(path, results)
    print("wrote", path, flush=True)
    return results


if __name__ == "__main__":
    main()
