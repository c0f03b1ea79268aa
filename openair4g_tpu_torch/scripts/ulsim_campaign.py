"""The uplink campaign: a PUSCH BLER mini-ladder and two fading curves
(counterpart of scripts/ulsim_campaign.py).

The reference treats ulsim as a harness of its own
(openair1/SIMULATION/LTE_PHY/ulsim.c:163) but ships no UL BLER corpus,
so these are measured curves in the DL ladder's CSV schema:

  * AWGN ladder, 25 PRB full allocation, the DMRS estimate, MCS {4, 10,
    16, 20, 23} (QPSK, 16QAM and 64QAM rows) -> DIR/awgn{N}.csv
  * two fading curves through the time-domain FIR channel (the
    reference's multipath_channel, ulsim.c:1202): EVA and ETU at MCS 10.

Each curve walks from its start in STEP_DB steps (N_TRIALS a point,
TAIL_TRIALS once the BLER is under TAIL_THRESH, with 1,024 to 8,191 a
point) until two points in a row have no error, up to 40 dB;
--snr-range START:STOP runs another stretch.

    python3 -m openair4g_tpu_torch.scripts.ulsim_campaign [n_trials]
        [sel|all] [--snr-range A:B] [--device cuda] [--out-dir DIR]

Writes DIR/<tag>.csv and DIR/<tag>.json (the curve, its SNR@50/10/1 %
crossings, "device" and "seconds"; a tag whose .json exists is skipped),
then DIR/ulsim_campaign.json with every curve in DIR.
"""
from __future__ import annotations

from ..sim.ulsim import Ulsim, UlsimConfig
from . import common

N_RB = 25
BATCH = 256
N_TRIALS = 2048
TAIL_TRIALS = 8192
TAIL_THRESH = 0.05
STEP_DB = 0.25
STOP_DB = 40.0

LADDER_MCS = (4, 10, 16, 20, 23)
# mcs -> sweep start (dB); QPSK from -8, 16QAM from 0, 64-QAM-ish later
START_DB = {4: -8.0, 10: -2.0, 16: 4.0, 20: 8.0, 23: 12.0}
FADING = (("eva", "EVA", 10, 0.0), ("etu70", "ETU", 10, 0.0))
FADING_START_DB = 2.0


def make_cfg(tag: str, n_rb: int = N_RB, batch: int = BATCH) -> tuple:
    """(UlsimConfig, start dB) of a tag: awgn<MCS> or a FADING name."""
    if tag.startswith("awgn"):
        mcs = int(tag[4:])
        return UlsimConfig(mcs=mcs, n_rb=n_rb, n_rb_alloc=n_rb,
                           channel="AWGN", batch=batch), START_DB[mcs]
    for t, chan, mcs, _ in FADING:
        if tag == t:
            return UlsimConfig(mcs=mcs, n_rb=n_rb, n_rb_alloc=n_rb,
                               channel=chan, batch=batch,
                               time_domain_channel=True), FADING_START_DB
    raise ValueError(tag)


def all_tags() -> list:
    return [f"awgn{m}" for m in LADDER_MCS] + [t for t, *_ in FADING]


def run_curve(tag: str, n_trials: int, dev, snr_range=None,
              n_rb: int = N_RB, batch: int = BATCH) -> tuple:
    """-> (CSV rows (snr, err0, trials0, 0), the curve's JSON)."""
    cfg, start = make_cfg(tag, n_rb, batch)
    start, stop = snr_range or (start, STOP_DB)
    sim = Ulsim(cfg, device=dev)
    rows = []
    zero_streak = 0
    s = start
    while s <= stop:
        errs, reach = sim.run_snr(float(s), n_trials)
        e, t = int(errs[0]), int(reach[0])
        if t and e / t < TAIL_THRESH and 1024 <= n_trials < TAIL_TRIALS:
            e2, t2 = sim.run_snr(float(s), TAIL_TRIALS - n_trials, seed=1)
            e += int(e2[0])
            t += int(t2[0])
        rows.append((float(s), e, t, 0))
        print(f"{tag} SNR {s:+6.2f}: {e}/{t} = {e / max(t, 1):.4f}",
              flush=True)
        zero_streak = zero_streak + 1 if e == 0 else 0
        if zero_streak >= 2:
            break
        s = round(s + STEP_DB, 2)
    snrs = [r[0] for r in rows]
    blers = [r[1] / max(r[2], 1) for r in rows]
    return rows, {"tag": tag, "mcs": cfg.mcs, "tbs": sim.ulsch.tbs,
                  "channel": cfg.channel,
                  "time_domain_channel": cfg.time_domain_channel,
                  "n_rb": cfg.n_rb, "n_rb_alloc": cfg.n_rb_alloc,
                  "snr": snrs, "bler0": blers,
                  "crossings": common.crossings(snrs, blers)}


def main(argv=None, n_rb: int = N_RB, batch: int = BATCH) -> dict:
    """The command line; n_rb and batch make a small run (tests)."""
    p = common.parser("ulsim_campaign", __doc__)
    p.add_argument("n_trials", nargs="?", type=int, default=N_TRIALS)
    p.add_argument("sel", nargs="?", default="all",
                   help="all, or comma-separated tags (awgn4, ..., eva)")
    p.add_argument("--snr-range", default=None,
                   help="START:STOP (dB) instead of the curve's walk")
    a = p.parse_args(argv)
    dev, out, card = common.setup("ulsim_campaign", a)
    tags = all_tags() if a.sel == "all" else a.sel.split(",")
    snr_range = common.snr_range(a.snr_range)

    def run_one(tag: str) -> dict:
        rows, res = run_curve(tag, a.n_trials, dev, snr_range, n_rb,
                              batch)
        common.write_bler_csv(out / f"{tag}.csv", rows, res["mcs"],
                              res["tbs"], "0")
        print(f"{tag} crossings={res['crossings']}", flush=True)
        return res

    common.run_each(tags, out, run_one, card)
    agg = common.collect(all_tags(), out)
    common.write_json(out / "ulsim_campaign.json", agg)
    print(f"wrote {out / 'ulsim_campaign.json'} ({len(agg)}/"
          f"{len(all_tags())})", flush=True)
    return agg


if __name__ == "__main__":
    main()
