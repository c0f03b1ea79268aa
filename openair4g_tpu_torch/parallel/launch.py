"""Run a function in the ranks of a new process group, one process a rank.

    results = spawn("openair4g_tpu_torch.parallel.checks:run_jobs", 2,
                    backend="gloo", workdir="build/par", kwargs={...})

Each rank is a fresh interpreter (never a fork: the caller may hold a
CUDA context) that joins the group through a file:// rendezvous in
`workdir`, runs `module:function(**kwargs)` with its kernel launch counts
set to 0, and hands back the value, its launches by (kernel, shape) and
its seconds through a file. It leaves the group before it exits. A rank
that fails or outlives `timeout` fails the call: every rank is killed and
the failing rank's output is in the error.
"""
from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]


def _rank_main(spec_path: str) -> None:
    """A rank's body: join, run, write the result, leave."""
    import torch
    import torch.distributed as dist

    from .. import kernels
    from ..device import launch_shapes, reset_launch_counts

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    module, name = spec["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    dist.init_process_group(spec["backend"], init_method=spec["init_method"],
                            rank=spec["rank"], world_size=spec["world"],
                            timeout=timedelta(seconds=spec["timeout"]))
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        value = fn(**spec["kwargs"])
        out = {"value": value, "launch_shapes": launch_shapes(),
               "seconds": time.perf_counter() - t0,
               "kernel_library": kernels.build_info.get("path"),
               "nvcc_ran": bool(kernels.build_info.get("ptxas"))}
        tmp = spec["out"] + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, spec["out"])
    finally:
        dist.destroy_process_group()


def spawn(target: str, world: int, *, backend: str, workdir, kwargs=None,
          timeout: float = 600.0, block=(), threads: int | None = None) -> list:
    """target(**kwargs) in `world` ranks of a new `backend` group; the
    list of each rank's {"value", "launch_shapes", "seconds",
    "kernel_library", "nvcc_ran", "log"} by rank. `workdir` must not hold
    an earlier spawn's rendezvous. `block` names modules each rank's
    interpreter may not import; `threads` sets its torch thread count;
    `timeout` bounds the whole call and each collective."""
    work = Path(workdir).resolve()
    work.mkdir(parents=True, exist_ok=True)
    rdzv = work / "rdzv"
    if rdzv.exists():
        raise FileExistsError(f"{rdzv}: an earlier rendezvous")
    code = ("import sys\n"
            f"for m in {list(block)!r}:\n"
            "    sys.modules[m] = None\n"
            "from openair4g_tpu_torch.parallel.launch import _rank_main\n"
            "_rank_main(sys.argv[1])\n")
    procs, logs = [], []
    for rank in range(world):
        spec = {"target": target, "rank": rank, "world": world,
                "backend": backend, "init_method": f"file://{rdzv}",
                "timeout": timeout, "kwargs": kwargs or {},
                "threads": threads, "out": str(work / f"rank{rank}.pkl")}
        spec_path = work / f"rank{rank}.spec"
        with open(spec_path, "wb") as f:
            pickle.dump(spec, f)
        logs.append(work / f"rank{rank}.log")
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(spec_path)], cwd=_ROOT,
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0]} of {world} exited with "
                                   f"{procs[bad[0]].returncode}:\n"
                                   + _tail(logs[bad[0]]))
            if time.monotonic() > deadline:
                raise TimeoutError(f"{target} on {world} ranks outlived "
                                   f"{timeout} s:\n" + _tail(logs[0]))
            time.sleep(0.05)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {world} exited with "
                                   f"{p.returncode}:\n" + _tail(logs[r]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, log in enumerate(logs):
        with open(work / f"rank{rank}.pkl", "rb") as f:
            out = pickle.load(f)
        out["log"] = log.read_text()
        results.append(out)
    return results


def _tail(log: Path, n: int = 6000) -> str:
    return log.read_text()[-n:]
