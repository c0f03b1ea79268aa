"""The faults a cell of this benchmark can have, planted in the program's
timed path, and the control: the readings that show the comparison fails
them, at a cell's own size.

    python3 -m phybench.faults --workload <cell> [--seed N] [--seconds 2]
        [--device cuda]

Runs the harness's run of the cell (phybench.run.run_cell, its look for a
card skipped) once sound, once with each fault planted, and once with the
control (the reference at TF32) in the program's place, all on one seed,
and prints one JSON line: each run's numbers compared and `correct`. One
chip a cell, so there is no exchange between chips to leave out.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager

import torch

from . import run, spec


def _tile(x, B: int):
    """x's rows repeated to B rows: the half that ran stands in for the
    half left out."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_tile(v, B) for v in x)
    if isinstance(x, dict):
        return {k: _tile(v, B) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(_tile(v, B) for v in x))
    reps = -(-B // x.shape[0])
    return torch.cat([x] * reps)[:B]


def _half(x):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return type(x)(_half(v) for v in x)
    if isinstance(x, dict):
        return {k: _half(v) for k, v in x.items()}
    return x[:(x.shape[0] + 1) // 2]


@contextmanager
def _patched(*changes):
    """setattr(owner, name, value) for each (owner, name, value), undone
    on leaving."""
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in changes]
    for owner, name, value in changes:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def state_unchanged():
    """The decode hands back the HARQ state it was given (zero buffers in
    a first round) in place of the combined buffers."""
    from openair4g_tpu_torch.phy import pdsch
    orig = pdsch.DlschCodec.decode

    def decode(self, e_llr, w_soft=None, rv=None, **kw):
        tb, ok, w = orig(self, e_llr, w_soft=w_soft, rv=rv, **kw)
        return tb, ok, (w_soft if w_soft is not None
                        else [torch.zeros_like(b) for b in w])
    return _patched((pdsch.DlschCodec, "decode", decode))


def half_batch():
    """Each round's channel and receiver run on half the rows, whose
    results stand in for the other half (at batch 1 the half is the
    whole: no fault)."""
    from openair4g_tpu_torch.sim import dlsim, ulsim
    orig_dl, orig_ul = dlsim.DlsimFading.round, ulsim.Ulsim.round_llrs

    def dl_round(self, rnd, tb_bits, d_flats, tap_draw, noise_normals, n0,
                 W, ev, w_soft=None, taps_prev=None):
        B = tb_bits.shape[0]
        res, taps = orig_dl(self, rnd, _half(tb_bits), _half(d_flats),
                            _half(tap_draw), _half(noise_normals), n0, W, ev,
                            _half(w_soft), _half(taps_prev))
        return _tile(res, B), _tile(taps, B)

    def ul_round(self, rnd, d_flats, uci_bits, tap_draw, noise_draw, n0, W):
        B = d_flats[0].shape[0]
        llr, streams = orig_ul(self, rnd, _half(d_flats), _half(uci_bits),
                               _half(tap_draw), _half(noise_draw), n0, W)
        return _tile(llr, B), _tile(streams, B)
    return _patched((dlsim.DlsimFading, "round", dl_round),
                    (ulsim.Ulsim, "round_llrs", ul_round))


def answer_altered():
    """The decode's CRC flag of the first row flipped where it is made."""
    from openair4g_tpu_torch.phy import pdsch
    orig = pdsch.DlschCodec.decode

    def decode(self, *a, **k):
        tb, ok, w = orig(self, *a, **k)
        ok = ok.clone()
        ok[0] = ~ok[0]
        return tb, ok, w
    return _patched((pdsch.DlschCodec, "decode", decode))


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}


def readings(cell: spec.Cell, seed: int, seconds: float, device) -> dict:
    """{run: {"correct", number: value}} for the sound run, each fault
    and the control, at the cell's own size."""
    def one(impl="port"):
        res = run.run_cell(cell, seed, seconds, False, device,
                           time.perf_counter(), impl)
        out = {"correct": res["correct"],
               **{k: c["value"] for k, c in res["checks"].items()}}
        print(json.dumps(out), file=sys.stderr, flush=True)
        return out
    out = {"sound": one()}
    for name, plant in FAULTS.items():
        with plant():
            out[name] = one()
    out["control"] = one("control")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="phybench.faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2 ** 31 + 4242)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = spec.load_cell(a.workload, run.CHECKOUT / "BENCHMARK.json")
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("phybench.faults: no CUDA device", file=sys.stderr)
        return 2
    out = readings(cell, a.seed, a.seconds, dev)
    print(json.dumps({"workload": cell.name, "seed": a.seed,
                      "batch": cell.traffic["batch"], **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
