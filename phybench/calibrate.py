"""The readings that a cell's limits are set from, in one process: the
numbers compared for the program on many seeds, and for the control on a
few. The control is the reference in the program's place, computed one
precision below the float32 the configurations state: TF32, its matrix
products' operands rounded to 10 mantissa bits (reference/device.mm), the
judge's own reference in float32.

    python3 -m phybench.calibrate --workload <cell> [--seeds 12]
        [--control-seeds 3] [--first-seed N] [--device cuda]

Each seed draws what a run compares (the traffic's compare_steps steps)
from its own generator and compares it. Prints one JSON line: each
reading, and each number's largest program reading and smallest control
reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import spec, traffic
from .run import CHECKOUT, tf32


def readings(cell: spec.Cell, program, ref, seed: int, device,
             lower_precision: bool = False) -> dict:
    """The numbers compared for `program` on the draws of `seed`."""
    drv = cell.sim
    params, mix = cell.config["params"], cell.traffic
    plan = drv.plan(params, mix)
    gen = traffic.generator(seed, device)
    records = []
    for _ in range(mix["compare_steps"]):
        x = traffic.draw(plan, gen, device)
        if lower_precision:
            with tf32():
                out = program.trial(x, keep=True)
        else:
            out = program.trial(x, keep=True)
        records.append(program.record(x, out))
    return drv.compare(records, params, mix, device, ref)


def calibrate(cell: spec.Cell, seeds: list, control_seeds: list,
              device) -> dict:
    drv = cell.sim
    params, mix = cell.config["params"], cell.traffic
    program = drv.Program(params, mix, device, "port")
    ref = drv.Program(params, mix, device, "reference")
    with tf32():
        control = drv.Program(params, mix, device, "reference")
    out = {"workload": cell.name, "program": [], "control": []}
    for seed in seeds:
        t0 = time.perf_counter()
        r = readings(cell, program, ref, seed, device)
        out["program"].append({"seed": seed, **r,
                               "seconds": time.perf_counter() - t0})
        print(json.dumps(out["program"][-1]), file=sys.stderr, flush=True)
    del program
    for seed in control_seeds:
        t0 = time.perf_counter()
        r = readings(cell, control, ref, seed, device, lower_precision=True)
        out["control"].append({"seed": seed, **r,
                               "seconds": time.perf_counter() - t0})
        print(json.dumps(out["control"][-1]), file=sys.stderr, flush=True)
    for k in cell.limits:
        out[f"{k}_program_max"] = max(r[k] for r in out["program"])
        if out["control"]:
            out[f"{k}_control_min"] = min(r[k] for r in out["control"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="phybench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = spec.load_cell(a.workload, CHECKOUT / "BENCHMARK.json")
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("phybench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [a.first_seed + 7919 * i for i in range(a.seeds)]
    control_seeds = [a.first_seed + 7919 * (a.seeds + i)
                     for i in range(a.control_seeds)]
    print(json.dumps(calibrate(cell, seeds, control_seeds, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
