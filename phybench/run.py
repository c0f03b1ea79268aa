"""Run one cell of the benchmark once, on one card, and print its result.

    python3 -m phybench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. A cell of BENCHMARK.json names a
configuration (configs/<name>.json: the simulator and its
parameters) and a traffic mix (workloads/<name>.json: batch, SNR,
warm-up, traced and compared steps); its limits are limits/<cell>.json and
its per-layer metrics' readers metrics/<metric>.py.

Set-up (counted in setup_s from the process's start): the imports, the
CUDA context, the kernels' library (built by nvcc on a checkout's first
run only, under build/kernels), the program's plans and estimator
matrices, and warm-up steps of the cell's own shapes. Then, with --trace
0, a closed loop: each step draws its inputs on the card from the seed,
calls the simulator's trial and reads the step's counts on the host, back
to back, until --seconds have passed; trials_per_s is every trial of the
window over the window's seconds, subframe_p95_ms the 95th percentile of
the steps' latency from the trial's call to its counts on the host. With
--trace 1, torch.profiler over the traffic's fixed number of steps, with
the benchmark's spans and hooks at the sites the metrics' files name, and
the per-layer metrics read from that trace.

After the steps, on a sample of them drawn from the seed: the reference
(phybench/reference, the plain chain, which imports nothing of the
program) recomputes what the program produced from the same draws, and
each number compared is held to its limit. The last lines on stderr give
each number with its limit; the last line on stdout is the result, as
JSON. Without a card, or with fewer than the cell asks for, it exits
non-zero and prints no result; likewise if jax, jaxlib, flax or the JAX
package is loaded once the steps are done.
"""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from . import spec, trace, traffic  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "openair4g_tpu")


def process_start() -> float:
    """The process's start on time.perf_counter()'s clock: its age read
    on the boot clock, which /proc's start time (10 ms steps) counts in,
    or the import of this module where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return T_IMPORT


@contextlib.contextmanager
def tf32():
    """TF32 on for matrix products (torch's flags, which reference/device.mm
    follows on any device): the control's precision."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def forbidden_loaded() -> list:
    """The forbidden top-level names among the loaded modules, compared
    whole (openair4g_tpu_torch is not openair4g_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def p95(values: list) -> float:
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        out["power_limit"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return out


def _log(msg: str) -> None:
    print(f"phybench: {msg}", file=sys.stderr, flush=True)


def _kernels_built() -> dict:
    """How the program's kernel library came to be loaded: the seconds it
    took (nvcc's build included, which set-up counts) and whether nvcc
    ran."""
    mod = sys.modules.get("openair4g_tpu_torch.kernels")
    info = getattr(mod, "build_info", {}) or {}
    return {"kernels_s": float(info.get("seconds", 0.0)),
            "nvcc_ran": bool(info.get("ptxas"))}


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float, impl: str = "port") -> dict:
    """One run of `cell`: set-up, the window or the traced steps, the
    comparison. t_start is on time.perf_counter()'s clock. impl "port"
    runs the program; "control" puts the reference in its place at TF32,
    the precision below the configurations' float32. Returns the result's
    fields, "checks" last."""
    drv = cell.sim
    params, mix = cell.config["params"], cell.traffic
    B = mix["batch"]
    metrics, missing, saved, store = {}, set(), [], {}
    if traced:
        metrics = {m["name"]: spec.metric_module(m["name"], cell.root)
                   for m in cell.per_layer}
        store["peaks"] = json.loads((cell.root / "peaks.json").read_text())
        saved, missing = trace.install(metrics, cell.config["sim"], store)
    if device.type == "cuda":
        torch.zeros(1, device=device)     # the context, before its counters
        torch.cuda.reset_peak_memory_stats(device)
    lower = contextlib.ExitStack()
    if impl == "control":
        lower.enter_context(tf32())
    t_build = time.perf_counter()
    program = drv.Program(params, mix, device,
                          "reference" if impl == "control" else "port")
    t_warm = time.perf_counter()
    plan = drv.plan(params, mix)
    gen = traffic.generator(seed, device)
    sample = traffic.Reservoir(mix["compare_steps"], seed)
    latencies = []

    def step(slot=None):
        x = traffic.draw(plan, gen, device)
        t0 = time.perf_counter()
        out = program.trial(x, keep=slot is not None)
        counts = program.counts(out).cpu()
        latencies.append(time.perf_counter() - t0)
        if slot is not None:
            sample.keep(slot, program.record(x, out))
        return counts

    for _ in range(mix["warmup_steps"]):
        step()
    _sync(device)
    built = _kernels_built()
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.3f} s: {t_build - t_start:.3f} s to the "
         f"program's construction (imports, CUDA context), "
         f"{t_warm - t_build:.3f} s to build it (plans, estimator matrices), "
         f"{time.perf_counter() - t_warm:.3f} s of {mix['warmup_steps']} "
         f"warm-up steps, of which {built['kernels_s']:.3f} s loading the "
         f"kernels' library (nvcc {'ran' if built['nvcc_ran'] else 'did not run'})")
    latencies.clear()
    totals = []

    def counted_step():
        totals.append(step(sample.slot()))

    result: dict = {}
    if traced:
        try:
            tr = trace.profile(counted_step, mix["trace_steps"], store,
                               device)
        finally:
            trace.restore(saved)
        values = {name: mod.read(tr) for name, mod in metrics.items()
                  if name not in missing}
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]),
                                         "unit": m["unit"]}
                             for m in cell.per_layer
                             if values.get(m["name"]) is not None}
        extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        result["breakdown"] = tr.breakdown()
    else:
        ends = []
        cpu_open = time.process_time()
        _log(f"window opened at {time.time():.3f} s of the epoch")
        t_open = time.perf_counter()
        while not ends or ends[-1] < seconds:
            counted_step()
            ends.append(time.perf_counter() - t_open)
        _sync(device)
        window_s = time.perf_counter() - t_open
        values = {"trials_per_s": len(ends) * B / window_s,
                  "subframe_p95_ms": p95(latencies) * 1e3,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        extra = {}
        per_second = collections.Counter(int(e) for e in ends)
        _log("steps completed in each second of the window: "
             f"{[per_second[i] for i in range(int(ends[-1]) + 1)]}")
        _log(f"{len(ends)} steps of {B} in {window_s:.3f} s; step latency "
             f"median {statistics.median(latencies) * 1e3:.3f} ms, p95 "
             f"{p95(latencies) * 1e3:.3f} ms; the process's CPU time "
             f"{time.process_time() - cpu_open:.3f} s")
    n_steps = len(totals)
    R = params.get("n_harq_rounds", 1)
    t = torch.stack(totals).sum(dim=0).tolist()
    _log(f"trials failing each round / reaching it: "
         f"{list(zip(t[:R], t[R:2 * R]))}"
         + (f"; round-0 UCI errors (cqi, ri, ack) {t[2 * R:]}"
            if len(t) > 2 * R else ""))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    result["device"] = {**_card(device), "memory_peak_bytes": peak, **extra}
    result["attempted"] = n_steps * B
    result["failed"] = 0
    lower.close()
    records = sample.records()
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        numbers = drv.compare(records, params, mix, device)
        _log(f"reference over {numbers['rows']} rows of {len(records)} steps"
             f" in {time.perf_counter() - t0:.3f} s; median soft gap "
             f"{numbers['soft_gap_median']:.3e}")
    except (RuntimeError, ValueError, IndexError, KeyError):
        # outputs of the wrong shape or kind cannot be compared: not correct
        traceback.print_exc()
        numbers = {}
    checks = {k: {"value": numbers.get(k), "limit": lim}
              for k, lim in cell.limits.items()}
    result["correct"] = all(c["value"] is not None and c["value"] <= c["limit"]
                            for c in checks.values())
    result["build"] = built
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(
        prog="phybench.run", description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True, help="a cell's name")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = spec.load_cell(a.workload, CHECKOUT / "BENCHMARK.json")
    if not torch.cuda.is_available():
        _log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        _log(f"{a.workload} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} present")
        return 2
    res = run_cell(cell, a.seed, a.seconds, bool(a.trace),
                   torch.device("cuda", 0), t_start)
    bad = forbidden_loaded()
    if bad:
        _log(f"loaded by the run: {', '.join(bad)}")
        return 3
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": res["device"]}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["build"] = res["build"]
    line["checks"] = res["checks"]
    for k, c in res["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
