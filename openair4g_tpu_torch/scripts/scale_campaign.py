"""Weak scaling of the sharded flagship step over ranks on one device
(counterpart of scripts/scale_campaign.py).

Runs graft_entry.make_flagship_sharded (100 PRB, MCS 26, EVA, joint CE,
round 0, 2 turbo iterations, 26 dB) in 1, 2 and 4 ranks, each a process
of its own (parallel/launch.spawn), at a fixed batch a rank, and
measures steps/s. As the reference's virtual CPU mesh did, this measures
one device's mechanics: every rank shares the one card (NCCL at world 1,
gloo beside it, since NCCL takes one rank a card) and the host's cores,
so the throughput retained against one rank isolates the sharding and
collective overhead (1.0 = none), not hardware scaling; the program is
the same on a real multi-card host. Each rank checks that its step
decodes TBs and misses no DCI.

    python3 -m openair4g_tpu_torch.scripts.scale_campaign
        [--device cuda] [--out-dir DIR]

Writes DIR/scale_campaign.json (resume: an existing file is not run
again).
"""
from __future__ import annotations

import shutil
import time

import torch
import torch.distributed as dist

from ..graft_entry import make_flagship_sharded
from ..parallel.launch import spawn
from . import common

MESHES = (1, 2, 4)
BATCH_PER_DEV = 2
N_REP = 6


def worker(device: str, batch_per_device: int, n_rep: int) -> dict:
    """A rank's body: the sharded step once to settle, then n_rep timed
    steps; the same row on every rank."""
    world = dist.get_world_size()
    run = make_flagship_sharded(world, batch_per_device=batch_per_device,
                                device=device)
    errs, miss, trials = run(0)
    if errs == trials or miss:
        raise RuntimeError(f"flagship sharded: {errs} TB errors and {miss} "
                           f"DCI misses of {trials}")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_rep):
        run(i + 1)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_rep
    return {"n_dev": world, "trials": trials, "step_seconds": dt,
            "subframes_per_s": trials / dt, "errs": errs, "dci_miss": miss}


def run(dev, out) -> dict:
    rows = []
    for n in MESHES:
        backend = "nccl" if dev.type == "cuda" and n == 1 else "gloo"
        work = out / f"ranks{n}"
        shutil.rmtree(work, ignore_errors=True)
        ranks = spawn("openair4g_tpu_torch.scripts.scale_campaign:worker",
                      n, backend=backend, workdir=work,
                      kwargs=dict(device=str(dev),
                                  batch_per_device=BATCH_PER_DEV,
                                  n_rep=N_REP))
        shutil.rmtree(work, ignore_errors=True)
        row = dict(ranks[0]["value"], backend=backend)
        rows.append(row)
        print(f"mesh {n} ({backend}): {row['subframes_per_s']:.2f} sf/s "
              f"({row['trials']} trials / {row['step_seconds']:.4f} s)",
              flush=True)
    total0 = rows[0]["subframes_per_s"]
    return {
        "config": "100 PRB MCS26 EVA estimated-CE round-0 step, "
                  f"{BATCH_PER_DEV}/rank, make_flagship_sharded over 'ue'",
        "caveat": "every rank shares one device and the host's cores: the "
                  "throughput-retained metric isolates sharding + "
                  "collective overhead (1.0 = none); hardware weak "
                  "scaling needs one device a rank, with the same program",
        "rows": rows,
        "throughput_retained_vs_mesh1": {
            str(r["n_dev"]): round(r["subframes_per_s"] / total0, 3)
            for r in rows}}


def main(argv=None) -> dict:
    p = common.parser("scale_campaign", __doc__)
    a = p.parse_args(argv)
    dev, out, card = common.setup("scale_campaign", a)
    return common.run_each(["scale_campaign"], out, lambda _: run(dev, out),
                           card)["scale_campaign"]


if __name__ == "__main__":
    main()
