"""Sweep harness (counterpart of openair4g_tpu/sim/harness.py): BLER CSVs in
the reference corpus' schema, resumable sweeps, and the dlsim-compatible
command line.

    python3 -m openair4g_tpu_torch.sim.harness -g EVA -r 4 -s 6 -S 10 \\
        -o build/eva.csv                # on a card
    python3 -m openair4g_tpu_torch.sim.harness --device cpu -B 6 -n 16 ...

`fullsim_main` is the full chain's command line (sim/fullsim.py), with
the same flags as the reference's and the same CSV:

    python3 -c "from openair4g_tpu_torch.sim.harness import fullsim_main; \\
        fullsim_main(['-B', '100', '-m', '26', '-g', 'EVA', '-b', '128'])"

The CSV row is `SNR;MCS;TBS;rate;err0;trials0;...;dci_err`, one err/trials
pair per HARQ round (or codeword). A sweep's state (per-SNR accumulators
and steps done) is a JSON sidecar, so a long sweep resumes where it
stopped. `--device` (default cuda) is the one flag the reference lacks:
with cuda and no card the command exits non-zero; it never falls back to
the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field

import numpy as np

from ..device import cli_device


def write_bler_csv(path: str, rows, mcs: int, tbs: int, rate: float,
                   dci_err: int = 0):
    """rows: list of (snr, errs [R], trials [R], bler [R])."""
    with open(path, "w") as f:
        for snr, errs, trials, _ in rows:
            cols = [f"{snr:g}", str(mcs), str(tbs), f"{rate:.6f}"]
            for e, t in zip(errs, trials):
                cols += [str(int(e)), str(int(t))]
            cols.append(str(dci_err))
            f.write(";".join(cols) + "\n")


@dataclass
class SweepState:
    """Resumable sweep accumulator, persisted as JSON."""
    config: dict
    seed: int = 0
    # per SNR: {"errs": [R], "trials": [R], "streams": steps done}
    points: dict = field(default_factory=dict)

    @classmethod
    def load(cls, path: str, config: dict, seed: int = 0) -> "SweepState":
        """The state saved at `path` if it was made for this config and
        seed, else a fresh one."""
        if os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            if d["config"] == config and d["seed"] == seed:
                return cls(config=config, seed=d["seed"], points=d["points"])
        return cls(config=config, seed=seed)

    def save(self, path: str):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"config": self.config, "seed": self.seed,
                       "points": self.points}, f)
        os.replace(tmp, path)

    def get(self, snr: float):
        return self.points.get(f"{snr:g}")

    def update(self, snr: float, errs, trials, streams: int):
        self.points[f"{snr:g}"] = {
            "errs": [int(x) for x in np.atleast_1d(errs)],
            "trials": [int(x) for x in np.atleast_1d(trials)],
            "streams": int(streams)}


def resumable_sweep(sim, snrs, n_frames: int, ckpt_path: str | None = None,
                    seed: int = 0, verbose: bool = True,
                    early_exit: bool = True):
    """SNR sweep with a checkpoint after each point; rows of (snr, errs,
    trials, bler), each an array over rounds or codewords.

    `sim` has .cfg (a dataclass with .batch) and .run_snr(snr, n_frames,
    seed) -> (errs, trials). Points the checkpoint holds in full are not
    run again."""
    config = dataclasses.asdict(sim.cfg)
    state = (SweepState.load(ckpt_path, config, seed) if ckpt_path
             else SweepState(config=config, seed=seed))
    rows = []
    n_streams = -(-n_frames // sim.cfg.batch)
    for s in snrs:
        s = float(s)
        done = state.get(s)
        if done and done["streams"] >= n_streams:
            errs = np.asarray(done["errs"], np.int64)
            trials = np.asarray(done["trials"], np.int64)
        else:
            errs, trials = sim.run_snr(s, n_frames, seed)
            state.update(s, errs, trials, n_streams)
            if ckpt_path:
                state.save(ckpt_path)
        errs = np.atleast_1d(errs)
        # one trial count shared by several codewords' errors
        trials = np.broadcast_to(np.atleast_1d(trials), errs.shape)
        bler = errs / np.maximum(trials, 1)
        rows.append((s, errs, trials, bler))
        if verbose:
            txt = " ".join(f"r{r}:{bler[r]:.4f}({errs[r]}/{trials[r]})"
                           for r in range(len(bler)))
            print(f"SNR {s:+6.2f} dB: {txt}", flush=True)
        if early_exit and errs[-1] == 0:
            break
    return rows


def dlsim_main(argv=None):
    """dlsim-compatible CLI: -x 1 runs DlsimAwgn on AWGN and DlsimFading
    otherwise, -x 2 DlsimTxDiv, -x 3..6 DlsimSm. Returns the sweep's
    rows."""
    from ..tables.tbs import get_G_dl, get_Qm, get_TBS_DL
    from .dlsim import DlsimAwgn, DlsimConfig, DlsimFading, DlsimFadingConfig

    p = argparse.ArgumentParser(
        prog="dlsim", description="PDSCH BLER Monte-Carlo (dlsim equivalent)")
    p.add_argument("-m", "--mcs", type=int, default=4)
    p.add_argument("-B", "--n-rb", type=int, default=25)
    p.add_argument("-x", "--tm", type=int, default=1,
                   help="transmission mode: 1 SISO | 2 SFBC | 3-6 SM")
    p.add_argument("-g", "--channel", default="AWGN",
                   help="AWGN | EPA | EVA | ETU")
    p.add_argument("-s", "--snr0", type=float, default=-4.0)
    p.add_argument("-S", "--snr1", type=float, default=4.0)
    p.add_argument("-i", "--snr-step", type=float, default=0.5)
    p.add_argument("-n", "--n-frames", type=int, default=1024)
    p.add_argument("-b", "--batch", type=int, default=128)
    p.add_argument("-t", "--turbo-iter", type=int, default=8)
    p.add_argument("-r", "--harq-rounds", type=int, default=4)
    p.add_argument("-o", "--csv", default=None, help="output CSV path")
    p.add_argument("--ckpt", default=None, help="checkpoint JSON path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back)")
    a = p.parse_args(argv)
    dev = cli_device("dlsim", a.device)

    snrs = np.arange(a.snr0, a.snr1 + 1e-9, a.snr_step)
    if a.tm == 2:
        from .dlsim_mimo import DlsimTxDiv, DlsimTxDivConfig
        sim = DlsimTxDiv(DlsimTxDivConfig(mcs=a.mcs, n_rb=a.n_rb,
                                          batch=a.batch,
                                          n_turbo_iter=a.turbo_iter), dev)
    elif a.tm in (3, 4, 5, 6):
        from .dlsim_sm import DlsimSm, DlsimSmConfig
        sim = DlsimSm(DlsimSmConfig(tm=a.tm, mcs=a.mcs, n_rb=a.n_rb,
                                    batch=a.batch,
                                    n_turbo_iter=a.turbo_iter), dev)
    elif a.channel.upper() == "AWGN":
        sim = DlsimAwgn(DlsimConfig(mcs=a.mcs, n_rb=a.n_rb, batch=a.batch,
                                    n_turbo_iter=a.turbo_iter), dev)
    else:
        sim = DlsimFading(DlsimFadingConfig(
            mcs=a.mcs, n_rb=a.n_rb, batch=a.batch,
            n_turbo_iter=a.turbo_iter, channel=a.channel.upper(),
            n_harq_rounds=a.harq_rounds), dev)
    rows = resumable_sweep(sim, snrs, a.n_frames, ckpt_path=a.ckpt,
                           seed=a.seed)
    if a.csv:
        tbs = get_TBS_DL(a.mcs, a.n_rb)
        G = get_G_dl(a.n_rb, get_Qm(a.mcs), 1)
        write_bler_csv(a.csv, rows, a.mcs, tbs, tbs / G)
        print(f"wrote {a.csv}")
    return rows


def fullsim_main(argv=None):
    """Full-chain (eNB TX -> UE RX incl. control channels) sweep CLI with
    the same CSV schema; the dci_err column carries real blind-decode
    misses (dlsim.c errs[0] accounting). Returns the sweep's rows."""
    from ..tables.tbs import get_G_dl, get_Qm, get_TBS_DL
    from .fullsim import FullChainSim, FullsimConfig

    p = argparse.ArgumentParser(
        prog="fullsim", description="full eNB-TX -> UE-RX chain BLER")
    p.add_argument("-m", "--mcs", type=int, default=4)
    p.add_argument("-B", "--n-rb", type=int, default=25)
    p.add_argument("-g", "--channel", default="AWGN")
    p.add_argument("-s", "--snr0", type=float, default=-4.0)
    p.add_argument("-S", "--snr1", type=float, default=4.0)
    p.add_argument("-i", "--snr-step", type=float, default=0.5)
    p.add_argument("-n", "--n-frames", type=int, default=256)
    p.add_argument("-b", "--batch", type=int, default=32)
    p.add_argument("-r", "--harq-rounds", type=int, default=4)
    p.add_argument("-o", "--csv", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back)")
    a = p.parse_args(argv)
    dev = cli_device("fullsim", a.device)

    sim = FullChainSim(FullsimConfig(
        n_rb=a.n_rb, mcs=a.mcs, channel=a.channel.upper(), batch=a.batch,
        n_harq_rounds=a.harq_rounds), dev)
    snrs = np.arange(a.snr0, a.snr1 + 1e-9, a.snr_step)
    rows = resumable_sweep(sim, snrs, a.n_frames, ckpt_path=a.ckpt,
                           seed=a.seed)
    if a.csv:
        tbs = get_TBS_DL(a.mcs, a.n_rb)
        G = get_G_dl(a.n_rb, get_Qm(a.mcs), 1)
        write_bler_csv(a.csv, rows, a.mcs, tbs, tbs / G,
                       dci_err=sim.dci_miss)
        print(f"wrote {a.csv}")
    return rows


if __name__ == "__main__":
    dlsim_main()
