"""The AWGN BLER ladder, MCS 0-27, against the reference's 28-curve
corpus (counterpart of scripts/awgn_campaign.py).

The reference's AWGN campaign (openair1/SIMULATION/LTE_PHY/
BLER_SIMULATIONS/AWGN/AWGN_results/bler_tx1_chan18_nrx1_mcs{0..27}.csv,
written by dlsim.c:779-780,3821): 5 MHz / 25 PRB SISO, 1 PDCCH symbol,
estimated channel, round-0 BLER on a 0.1 dB grid. Each curve is run under
the same conditions (est_mode="interp", the reference's per-pilot-symbol
estimator; snr_convention="dlsim", its grid-average noise calibration):
N_TRIALS a point, TAIL_TRIALS once the BLER is under TAIL_THRESH (with
2,048 or more a point), until two points in a row have no error.

The corpus CSVs are not in this repository. So the corpus's SNR@50/10/1 %
crossings and each MCS's TBS are copied here (REF) from the `ref` and
`tbs` entries of the repo's awgn_campaign.json, and the grid runs from
that run's first SNR (the corpus's first - 3 dB) to the later of its last
SNR and the corpus's 1 % crossing (GRID); --snr-range START:STOP runs
another stretch of it.

    python3 -m openair4g_tpu_torch.scripts.awgn_campaign [n_trials]
        [mcs_list|all] [--snr-range A:B] [--device cuda] [--out-dir DIR]

Writes DIR/mcs{N}.csv in the reference's CSV schema and DIR/mcs{N}.json
(the curve, its crossings, the corpus's, the difference in dB, "device"
and "seconds"); an MCS whose .json exists is skipped (resume). Then
DIR/awgn_campaign.json holds every curve in DIR.
"""
from __future__ import annotations

import math

import numpy as np

from ..sim.dlsim import DlsimFading, DlsimFadingConfig
from . import common

N_RB = 25             # the corpus's 5 MHz
BATCH = 256
N_TRIALS = 2048
TAIL_TRIALS = 8192
TAIL_THRESH = 0.05
STEP_DB = 0.1

# mcs: (TBS, the corpus curve's SNR (dB) where its round-0 BLER crosses
# 50 %, 10 % and 1 %)
REF = {
    0: (680, -2.944468215383222, -2.317349577774565,
        0.22347785343433088),
    1: (904, -2.0877665409002915, -1.5628479387866954,
        0.9138534341661301),
    2: (1096, -1.5095453063168738, -1.0254577559409768,
        1.3887513429170633),
    3: (1416, -0.6749576255882899, -0.2227333827544329,
        2.146992751182684),
    4: (1800, 0.14413836673835187, 0.5892180764421437,
        3.077281245428946),
    5: (2216, 0.8604084198495255, 1.2531829217186203,
        3.180049883503601),
    6: (2600, 1.3749453846004855, 1.7454005468812652,
        4.467046447979471),
    7: (3112, 2.2360308495736203, 2.5593459007513406,
        4.218847309201844),
    8: (3496, 2.8479802492594666, 3.1522458071452246,
        4.087370517576018),
    9: (4008, 3.5151046894520213, 3.803698886337252,
        4.269519015137653),
    10: (4008, 4.865301417589293, 5.288530384272854,
        9.05628696587794),
    11: (4392, 5.188242966623166, 5.447434446137944,
        5.748892310479503),
    12: (4968, 5.6424551879638765, 5.881529022937247,
        6.088237408443104),
    13: (5736, 6.561955236734941, 6.7864111103682285,
        6.989067922936093),
    14: (6456, 7.538361702198571, 7.899522579376992,
        10.82326620930761),
    15: (7224, 8.263932231617638, 8.582041714905012,
        10.531310152803401),
    16: (7736, 8.773978068428214, 9.046321372632097,
        9.75146803229813),
    17: (7736, 9.87877241858239, 10.159943913015722,
        11.277661243264722),
    18: (7992, 10.066928406102576, 10.320668029821269,
        10.555448007337445),
    19: (9144, 11.268623930422411, 11.534092710826922,
        12.044169834951147),
    20: (9912, 11.86254264081932, 12.124120951820787,
        12.862687913898776),
    21: (10680, 12.59867981097289, 12.878296577376235,
        13.705069459682143),
    22: (11448, 13.1730427950455, 13.425258172220628,
        13.662070956948284),
    23: (12576, 14.295946603788071, 14.572269649334869,
        14.852441964413236),
    24: (13536, 15.034642412381716, 15.317451068182212,
        15.6),
    25: (14112, 15.656153121659164, 15.943221185193913,
        16.259149066273434),
    26: (15264, 16.570254805143595, 16.856302233791652,
        17.14314755512596),
    27: (15840, 16.986005060002494, 17.28844429132682,
        17.824244741272864),
}

# mcs: (the committed run's first and last SNR, dB). Its first is the
# corpus curve's first - 3 dB (GRID_EXTEND_DB); its walk ended after two
# zero points, at or before the corpus grid's end.
GRID = {0: (-10.0, -0.5), 1: (-9.0, -1.1), 2: (-8.0, -0.7), 3: (-7.0, -1.0),
        4: (-6.0, -0.9), 5: (-5.0, -0.2), 6: (-4.0, 0.5), 7: (-3.0, 1.3),
        8: (-2.0, 1.9), 9: (-1.0, 2.9), 10: (-2.0, 3.8), 11: (-1.0, 4.2),
        12: (0.0, 4.7), 13: (1.0, 5.6), 14: (2.0, 6.9), 15: (3.0, 7.6),
        16: (2.0, 8.3), 17: (3.0, 9.3), 18: (4.0, 9.5), 19: (5.0, 10.7),
        20: (6.0, 11.3), 21: (7.0, 12.2), 22: (8.0, 12.7), 23: (9.0, 14.1),
        24: (10.0, 14.8), 25: (11.0, 15.6), 26: (12.0, 16.4),
        27: (13.0, 17.2)}


def grid(mcs: int, snr_range=None) -> np.ndarray:
    """The SNR grid of one curve: GRID's first SNR to the later of its
    last and the corpus's 1 % crossing, or snr_range = (start, stop)."""
    if snr_range is None:
        start, last = GRID[mcs]
        snr_range = (start, max(last, math.ceil(REF[mcs][3] * 10) / 10))
    start, stop = snr_range
    return np.round(np.arange(start, stop + STEP_DB / 2, STEP_DB), 2)


def run_curve(mcs: int, n_trials: int, dev, snr_range=None,
              n_rb: int = N_RB, batch: int = BATCH) -> tuple:
    """-> (the CSV rows (snr, err0, trials0, dci_err), the curve's JSON).
    Another n_rb than the corpus's (a small run) skips the TBS check."""
    cfg = DlsimFadingConfig(mcs=mcs, n_rb=n_rb, channel="AWGN",
                            n_pdcch_symbols=1, n_rx=1, n_harq_rounds=1,
                            batch=batch, est_mode="interp",
                            snr_convention="dlsim")
    sim = DlsimFading(cfg, device=dev)
    tbs, G = sim.dlsch.cfg.tbs, sim.dlsch.cfg.G
    if n_rb == N_RB and tbs != REF[mcs][0]:
        raise ValueError(f"MCS {mcs}: TBS {tbs}, the corpus's {REF[mcs][0]}")
    rows = []
    zero_streak = 0
    tail_trials = TAIL_TRIALS if n_trials >= N_TRIALS else n_trials
    for s in grid(mcs, snr_range):
        errs, reach = sim.run_snr(float(s), n_trials)
        e, t, dc = int(errs[0]), int(reach[0]), int(sim.dci_miss)
        if t and e / t < TAIL_THRESH and n_trials < tail_trials:
            errs2, reach2 = sim.run_snr(float(s), tail_trials - n_trials,
                                        seed=1)
            e += int(errs2[0])
            t += int(reach2[0])
            dc += int(sim.dci_miss)
        rows.append((float(s), e, t, dc))
        print(f"mcs{mcs} SNR {s:+6.2f}: {e}/{t} = {e / max(t, 1):.4f} "
              f"dci_err {dc}", flush=True)
        zero_streak = zero_streak + 1 if e == 0 else 0
        if zero_streak >= 2:
            break
    snrs = [r[0] for r in rows]
    blers = [r[1] / max(r[2], 1) for r in rows]
    ours = common.crossings(snrs, blers)
    ref = dict(zip(common.LEVELS, REF[mcs][1:]))
    out = {"mcs": mcs, "tbs": tbs, "G": G, "rate": tbs / G,
           "est_mode": cfg.est_mode, "snr_convention": cfg.snr_convention,
           "n_turbo_iter": cfg.n_turbo_iter, "snr": snrs, "bler0": blers,
           "ours": ours, "ref": ref,
           "delta_db": {lvl: (None if ours[lvl] is None
                              else round(ours[lvl] - ref[lvl], 3))
                        for lvl in common.LEVELS}}
    return rows, out


def main(argv=None, n_rb: int = N_RB, batch: int = BATCH) -> dict:
    """The command line; n_rb and batch make a small run (tests)."""
    p = common.parser("awgn_campaign", __doc__)
    p.add_argument("n_trials", nargs="?", type=int, default=N_TRIALS)
    p.add_argument("mcs", nargs="?", default="all",
                   help="all, or a comma-separated list of MCS")
    p.add_argument("--snr-range", default=None,
                   help="START:STOP (dB) instead of the curve's grid")
    a = p.parse_args(argv)
    dev, out, card = common.setup("awgn_campaign", a)
    mcss = list(range(28)) if a.mcs == "all" \
        else [int(x) for x in a.mcs.split(",")]
    snr_range = common.snr_range(a.snr_range)

    def run_one(name: str) -> dict:
        mcs = int(name[3:])
        rows, res = run_curve(mcs, a.n_trials, dev, snr_range, n_rb, batch)
        common.write_bler_csv(out / f"{name}.csv", rows, mcs, res["tbs"],
                              f"{res['rate']:.6f}")
        print(f"{name} delta_db={res['delta_db']}", flush=True)
        return res

    common.run_each([f"mcs{m}" for m in mcss], out, run_one, card)
    agg = common.collect([f"mcs{m}" for m in range(28)], out)
    common.write_json(out / "awgn_campaign.json", agg)
    print(f"wrote {out / 'awgn_campaign.json'} ({len(agg)}/28 curves)",
          flush=True)
    return agg


if __name__ == "__main__":
    main()
