"""Multi-process BLER sweeps on torch.distributed (counterpart of
openair4g_tpu/parallel/distributed.py).

Reference parity: distributed oaisim (`-M`) — eNB/UE instances sharded
across machines exchanging per-frame buffers over IP multicast / OpenPGM
(SIMULATION/ETH_TRANSPORT/{emu_transport.c, multicast_link.c,
pgm_link.c}; master/worker frame barriers), and launch_sim.sh's PBS
cluster sweeps. Here every process is one rank of one process group and
drives one device; the Monte-Carlo batch is sharded over the ranks and
the error counts are summed with `all_reduce` (NCCL on cards, one card a
rank; gloo on the CPU, or for ranks that share one card).

Determinism: every rank draws the whole global batch of a chunk from the
point's generator and keeps its rows (utils/rng.py), so an N-process
sweep equals the one-process sweep with the same global batch (SURVEY.md
§4's multi-host test requirement).

Checkpoint/resume: sweep progress (per-SNR accumulators and the chunk
index) persists through sim/harness.py's SweepState on rank 0, which
broadcasts each point's resume state to the other ranks; a resumed point
reaches its chunk by drawing and discarding the chunks before it.

Single-process use (tests) needs no coordinator: the mesh is one rank.
Multi-process use:

    # on every process p of P (one a device):
    python -m openair4g_tpu_torch.parallel.distributed \\
        --coordinator host0:1234 --nprocs P --proc-id p \\
        --mcs 4 --n-rb 25 --snrs -2:2:0.5 --frames 10000
    # P ranks sharing one card: add --backend gloo
"""
from __future__ import annotations

import argparse
import json
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import cli_device, resolve_device
from .mesh import default_backend, ensure_process_group
from .sweep import ShardedSweep


def init_multihost(coordinator: str | None, nprocs: int, proc_id: int,
                   device, backend: str | None = None,
                   timeout_s: float = 600.0) -> None:
    """torch.distributed bring-up: rank proc_id of nprocs, rendezvous at
    `coordinator` (host:port, or a tcp:// or file:// URL), on `backend`
    (None: nccl for a CUDA device, gloo for the CPU), collectives that
    fail after timeout_s. No-op for a single process."""
    if nprocs > 1:
        if not coordinator:
            raise ValueError("nprocs > 1 needs a coordinator")
        if "://" not in coordinator:
            coordinator = f"tcp://{coordinator}"
        dist.init_process_group(
            backend or default_backend(device), init_method=coordinator,
            world_size=nprocs, rank=proc_id,
            timeout=timedelta(seconds=timeout_s))


def global_mesh(axis: str = "ue", device=None):
    """One mesh axis over every rank of the process group (`device`,
    None: the card, gives its device type)."""
    dev = resolve_device(device)
    ensure_process_group(dev)
    return init_device_mesh(dev.type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


class DistributedSweep(ShardedSweep):
    """Globally sharded Monte-Carlo accumulator over every rank; the
    reduced error count is the same on every rank. run_snr resumes at
    chunk stream0 of the point."""

    def __init__(self, sim, mesh=None, batch_per_device: int = 32,
                 axis: str = "ue"):
        super().__init__(sim, mesh or global_mesh(axis, sim.device),
                         batch_per_device, axis)

    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0,
                stream0: int = 0):
        """(errs, trials, next chunk) over ceil(n_frames / batch) chunks
        from chunk stream0."""
        return self._run(snr_db, n_frames, seed, stream0)


def distributed_bler_sweep(sim_factory, snrs, n_frames: int, mesh=None,
                           batch_per_device: int = 32, seed: int = 0,
                           ckpt_path: str | None = None,
                           verbose: bool = True):
    """Full sweep: sim_factory() -> a simulator for DistributedSweep
    (cfg.batch the global batch). Returns rows of (snr, errs, trials);
    stops after the first point without an error. Rank 0 owns the
    checkpoint file and broadcasts each point's resume state."""
    from ..sim.harness import SweepState
    sim = sim_factory()
    sweep = DistributedSweep(sim, mesh=mesh, batch_per_device=batch_per_device)
    rank0 = dist.get_rank() == 0
    state = None
    if ckpt_path and rank0:
        state = SweepState.load(ckpt_path, config=dict(
            kind="distributed", seed=seed, batch=sweep.batch,
            snrs=[float(s) for s in snrs], n_frames=n_frames))
    rows = []
    for s in snrs:
        start = [0, 0, 0]
        if state is not None and state.get(float(s)) is not None:
            pt = state.get(float(s))
            start = [pt["errs"][0], pt["trials"][0], pt["streams"]]
        start = torch.tensor(start, dtype=torch.int64, device=sim.device)
        dist.broadcast(start, src=0)
        errs0, trials0, stream0 = (int(x) for x in start)
        remaining = n_frames - trials0
        if remaining > 0:
            e, t, next_stream = sweep.run_snr(float(s), remaining, seed=seed,
                                              stream0=stream0)
            errs0 += e
            trials0 += t
            if state is not None:
                state.update(float(s), errs0, trials0, next_stream)
                state.save(ckpt_path)
        rows.append((float(s), errs0, trials0))
        if verbose and rank0:
            print(f"SNR {s:+6.2f} dB: bler {errs0 / max(trials0, 1):.4f} "
                  f"({errs0}/{trials0}) on {sweep.n_dev} ranks "
                  f"({dist.get_backend()}, {sim.device})", flush=True)
        if errs0 == 0:
            break
    return rows


def _parse_snrs(spec: str):
    lo, hi, step = (float(x) for x in spec.split(":"))
    return np.arange(lo, hi + 1e-9, step)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="multi-process AWGN dlsim sweep, one process a device",
        epilog="The reference's --platform and --host-devices have no "
        "counterpart: one process is one device, named by --device.")
    p.add_argument("--coordinator", default=None,
                   help="host:port, tcp://host:port or file:///path")
    p.add_argument("--nprocs", type=int, default=1)
    p.add_argument("--proc-id", type=int, default=0)
    p.add_argument("--mcs", type=int, default=4)
    p.add_argument("--n-rb", type=int, default=25)
    p.add_argument("--snrs", default="-4:4:1.0")
    p.add_argument("--frames", type=int, default=1024)
    p.add_argument("--batch-per-device", type=int, default=32)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--out", default=None,
                   help="rank 0 writes rows as JSON here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exits without a card) or cpu")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on cuda, gloo on cpu; gloo lets "
                   "several ranks share one card")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds before a collective counts as failed")
    a = p.parse_args(argv)
    dev = cli_device("distributed", a.device)
    init_multihost(a.coordinator, a.nprocs, a.proc_id, dev, a.backend,
                   a.timeout)
    ensure_process_group(dev, a.backend)
    try:
        world = dist.get_world_size()

        def factory():
            from ..sim.dlsim import DlsimAwgn, DlsimConfig
            return DlsimAwgn(DlsimConfig(
                mcs=a.mcs, n_rb=a.n_rb, batch=a.batch_per_device * world),
                device=dev)

        rows = distributed_bler_sweep(factory, _parse_snrs(a.snrs), a.frames,
                                      batch_per_device=a.batch_per_device,
                                      ckpt_path=a.ckpt)
        if a.out and dist.get_rank() == 0:
            with open(a.out, "w") as f:
                json.dump(rows, f)
    finally:
        dist.destroy_process_group()
    return rows


if __name__ == "__main__":
    main()
