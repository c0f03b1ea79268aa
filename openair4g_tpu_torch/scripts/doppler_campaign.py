"""The high-Doppler sweep (counterpart of scripts/doppler_campaign.py).

The reference ships BLER-against-speed curves
(openair1/SIMULATION/LTE_PHY/BLER_SIMULATIONS/bler_{0,66,..,550}.m) and
its DL estimator has a high-speed mode (lte_dl_channel_estimation.c:
643-665, linear interpolation in time between pilot symbols). This sweep
stresses the same axis:

  * DL EVA/ETU at intra-subframe Doppler 70/200/300 Hz (Jakes-correlated
    tap states per OFDM symbol), MCS 10 at 5 MHz, estimated channel, with
    both estimators: "interp" (the high-speed analog) and "joint" (the
    quasi-static 2D LMMSE); joint is expected to fail at 300 Hz where
    interp holds.
  * restricted-set PRACH detection at high Doppler through the time-domain
    path, at carrier offsets of 0, 200 and 400 Hz (the restricted set is
    built for this regime, 36.211 §5.7.2).

    python3 -m openair4g_tpu_torch.scripts.doppler_campaign [n_trials]
        [--device cuda] [--out-dir DIR]

Writes DIR/doppler_campaign.json in the schema of the repo's
doppler_campaign.json plus "device" and "seconds"; an existing file is
not run again (resume).
"""
from __future__ import annotations

import time

from ..sim.dlsim import DlsimFading, DlsimFadingConfig
from ..sim.prachsim import Prachsim, PrachsimConfig
from . import common

DOPPLERS = (70.0, 200.0, 300.0)
SNRS = (8.0, 10.0, 12.0, 14.0)
CHANNELS = ("EVA", "ETU")
PRACH_CFO_HZ = (0.0, 200.0, 400.0)


def run(n_trials: int, dev) -> dict:
    out = {"n_trials": n_trials, "dl": [], "prach": []}
    t00 = time.time()
    for chan in CHANNELS:
        for mode in ("interp", "joint"):
            for fd in DOPPLERS:
                sim = DlsimFading(DlsimFadingConfig(
                    mcs=10, n_rb=25, channel=chan, n_harq_rounds=1,
                    est_mode=mode, intra_doppler_hz=fd, batch=256,
                    n_turbo_iter=6), device=dev)
                row = {"channel": chan, "est_mode": mode,
                       "doppler_hz": fd, "points": []}
                for s in SNRS:
                    t0 = time.time()
                    errs, reach = sim.run_snr(float(s), n_trials)
                    row["points"].append({
                        "snr_db": s, "err0": int(errs[0]),
                        "trials": int(reach[0]),
                        "bler0": round(int(errs[0]) /
                                       max(int(reach[0]), 1), 5),
                        "dci_err": int(sim.dci_miss),
                        "seconds": round(time.time() - t0, 1)})
                    print(f"{chan} {mode} fd={fd:.0f} SNR{s:+.1f}: "
                          f"{errs[0]}/{reach[0]}", flush=True)
                out["dl"].append(row)
    for cfo in PRACH_CFO_HZ:
        sim = Prachsim(PrachsimConfig(
            root_u=22, ncs=22, high_speed=True, time_domain=True,
            max_delay=8, batch=64, cfo_hz=cfo), device=dev)
        r = sim.run_snr(-6.0, n_batches=max(2, n_trials // 128))
        r["cfo_hz"] = cfo
        out["prach"].append(r)
        print(f"prach restricted cfo={cfo}: det {r['det_rate']:.4f} "
              f"fa {r['false_per_trial']:.4f}", flush=True)
    out["seconds_total"] = round(time.time() - t00, 1)
    return out


def main(argv=None) -> dict:
    p = common.parser("doppler_campaign", __doc__)
    p.add_argument("n_trials", nargs="?", type=int, default=4096)
    a = p.parse_args(argv)
    dev, out, card = common.setup("doppler_campaign", a)
    res = common.run_each(["doppler_campaign"], out,
                          lambda _: run(a.n_trials, dev), card)
    return res["doppler_campaign"]


if __name__ == "__main__":
    main()
