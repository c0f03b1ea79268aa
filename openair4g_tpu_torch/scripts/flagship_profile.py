"""A/B profile of the 20 MHz flagship chain with pieces swapped out
(counterpart of scripts/flagship_profile.py).

Times the flagship's round-0 step (DlsimFading 100 PRB, MCS 26, EVA, 1
RX, joint CE, 8 iterations, batch 64, 24 dB) as it is and with the PDCCH
off, the channel known, 4 and 2 turbo iterations, and MCS 4; each the
best of 3 windows of 8 steps on the host clock between device syncs,
after one warm-up step, with utils/profiler's stage timers off.

    python3 -m openair4g_tpu_torch.scripts.flagship_profile
        [--device cuda] [--out-dir DIR]

Writes DIR/flagship_profile.json (the rows and each variant's difference
to the full step; resume: an existing file is not run again).
"""
from __future__ import annotations

import numpy as np
import torch

from ..bench import stage_timers_off, time_windows
from ..sim.dlsim import DlsimFading, DlsimFadingConfig
from . import common

BATCH = 64
SNR = 24.0
N_REP, WINDOWS = 8, 3
VARIANTS = [("full", {}), ("no_pdcch", dict(with_pdcch=False)),
            ("perfect_ce", dict(perfect_ce=True)),
            ("iter4", dict(n_turbo_iter=4)), ("iter2", dict(n_turbo_iter=2)),
            ("mcs4(QPSK small TBS)", dict(mcs=4))]


def step_seconds(dev, **kw) -> float:
    cfg = dict(mcs=26, n_rb=100, channel="EVA", n_rx=1, n_harq_rounds=1,
               batch=BATCH, est_mode="joint", n_turbo_iter=8)
    cfg.update(kw)
    sim = DlsimFading(DlsimFadingConfig(**cfg), device=dev)
    n0 = np.float32(10.0 ** (-SNR / 10.0))
    W, ev = sim.wiener(SNR), sim.err_var(SNR)
    gen = torch.Generator(device=dev).manual_seed(0)
    with stage_timers_off():
        secs, _ = time_windows(lambda: sim.step(gen, n0, W, ev), dev,
                               N_REP, WINDOWS)
    return min(secs) / N_REP


def run(dev) -> dict:
    rows = []
    for name, kw in VARIANTS:
        dt = step_seconds(dev, **kw)
        rows.append({"name": name, "ms_per_batch": dt * 1e3,
                     "subframes_per_s": BATCH / dt})
        print(f"{name:24s}: {dt * 1e3:7.2f} ms/batch  "
              f"{BATCH / dt:8.1f} sf/s", flush=True)
    full = rows[0]["ms_per_batch"]
    for row in rows[1:]:
        row["delta_ms"] = full - row["ms_per_batch"]
        print(f"{row['name']:24s}: delta {row['delta_ms']:+6.2f} ms",
              flush=True)
    return {"batch": BATCH, "snr_db": SNR, "rows": rows}


def main(argv=None) -> dict:
    p = common.parser("flagship_profile", __doc__)
    a = p.parse_args(argv)
    dev, out, card = common.setup("flagship_profile", a)
    return common.run_each(["flagship_profile"], out, lambda _: run(dev),
                           card)["flagship_profile"]


if __name__ == "__main__":
    main()
