"""What the campaign programs share: the command line (the reference's
positional arguments plus --device and --out-dir), the output directory
(results_torch/<program>/ under the repo root unless --out-dir names
another), resume by existing output file, the BLER crossing and the
reference's CSV schema (scripts/awgn_campaign.py:116-121,
scripts/ulsim_campaign.py:86-90)."""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from ..device import card_name, cli_device

ROOT = Path(__file__).resolve().parents[2]
RESULTS = ROOT / "results_torch"
CSV_HEADER = ("SNR; MCS; TBS; rate; err0; trials0; err1; trials1; "
              "err2; trials2; err3; trials3; dci_err\n")
LEVELS = ("0.5", "0.1", "0.01")


def parser(prog: str, doc: str) -> argparse.ArgumentParser:
    """The program's parser with --device and --out-dir; the caller adds
    the reference's positional arguments."""
    p = argparse.ArgumentParser(prog=prog, description=doc.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back)")
    p.add_argument("--out-dir", default=None,
                   help=f"output directory (default results_torch/{prog})")
    return p


def default_out(prog: str) -> Path:
    return RESULTS / prog


def setup(prog: str, args) -> tuple:
    """(device, output directory, the card's name) of a parsed command
    line; a CUDA device that is not there ends the program."""
    dev = cli_device(prog, args.device)
    out = Path(args.out_dir) if args.out_dir else default_out(prog)
    out.mkdir(parents=True, exist_ok=True)
    return dev, out, card_name(dev)


def crossing(snrs, blers, level):
    """First SNR where the curve falls below `level` (log-linear interp);
    None if it never does within the grid."""
    b = np.maximum(np.asarray(blers, float), 1e-9)
    s = np.asarray(snrs, float)
    below = np.nonzero(b < level)[0]
    if len(below) == 0:
        return None
    i = below[0]
    if i == 0:
        return float(s[0])
    l0, l1 = np.log10(b[i - 1]), np.log10(b[i])
    t = (np.log10(level) - l0) / (l1 - l0)
    return float(s[i - 1] + t * (s[i] - s[i - 1]))


def crossings(snrs, blers) -> dict:
    return {lvl: crossing(snrs, blers, float(lvl)) for lvl in LEVELS}


def write_bler_csv(path, rows, mcs: int, tbs: int, rate: str) -> None:
    """rows of (snr, err0, trials0, dci_err) in the reference's schema;
    `rate` as the reference writes it."""
    with open(path, "w") as f:
        f.write(CSV_HEADER)
        for s, e, t, dc in rows:
            f.write(f"{s:.6f};{mcs};{tbs};{rate};{e};{t};"
                    f"0;0;0;0;0;0;{dc}\n")


def write_json(path, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def run_each(names, out: Path, run_one, card: str) -> dict:
    """{name: result} for each name: run_one(name) -> dict, written to
    out/<name>.json with "seconds" and "device" (the card) added; a name
    whose file exists is skipped and its file read (resume)."""
    results = {}
    for name in names:
        path = out / f"{name}.json"
        if path.exists():
            print(f"{name}: exists, skipping", flush=True)
        else:
            t0 = time.time()
            res = run_one(name)
            res["seconds"] = round(time.time() - t0, 1)
            res["device"] = card
            write_json(path, res)
        results[name] = read_json(path)
    return results


def collect(names, out: Path) -> dict:
    """{name: result} of each name whose out/<name>.json exists."""
    return {n: read_json(out / f"{n}.json") for n in names
            if (out / f"{n}.json").exists()}


def snr_list(text: str | None):
    """"a,b,c" -> [a, b, c] floats; None stays None."""
    return None if text is None else [float(x) for x in text.split(",")]


def snr_range(text: str | None):
    """"start:stop" -> (start, stop) floats; None stays None."""
    if text is None:
        return None
    start, stop = (float(x) for x in text.split(":"))
    return start, stop


def two_proportion_z(k1: int, n1: int, k2: int, n2: int) -> float:
    """|p1 - p2| in standard deviations of the pooled two-proportion test;
    0 when both proportions are equal, inf when they differ and the pooled
    proportion is 0 or 1."""
    p1, p2 = k1 / n1, k2 / n2
    p = (k1 + k2) / (n1 + n2)
    sd = np.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    if sd == 0:
        return 0.0 if p1 == p2 else float("inf")
    return float(abs(p1 - p2) / sd)


def out_path(out: Path, given: str | None, default: str) -> Path:
    """The aggregate file: `given` (a path) or out/default."""
    return Path(given) if given else out / default

