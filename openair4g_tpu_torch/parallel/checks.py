"""Rank programs that drive the parallel modules for their checks: each
runs in every rank of an initialised process group (launch.spawn) and
returns host values, which the caller holds against the one-process
counterparts (the sim's own run_snr, phy/sync.CellSearch, the reference).

    spawn("openair4g_tpu_torch.parallel.checks:run_jobs", 2, backend="gloo",
          workdir=..., kwargs={"jobs": [("pss_correlate", {...}), ...]})

A job's `device` is where its tensors live; `sim` holds DlsimConfig
fields beside the batch, which the mesh sets.
"""
from __future__ import annotations

import itertools
import time

import numpy as np
import torch
import torch.distributed as dist

from ..graft_entry import entry, make_flagship_sharded
from ..sim.dlsim import DlsimAwgn, DlsimConfig
from .distributed import DistributedSweep, distributed_bler_sweep
from .mesh import make_mesh
from .sweep import ShardedSweep
from .timeshard import exchange_halo, halo_via_host, sharded_pss_correlate


def run_jobs(jobs: list) -> list:
    """[(name, kwargs)] -> [name(**kwargs)], in order, in one group."""
    return [globals()[name](**kw) for name, kw in jobs]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _awgn(device, batch: int, sim: dict) -> DlsimAwgn:
    return DlsimAwgn(DlsimConfig(batch=batch, **sim), device=device)


def sharded_sweep(device, n_ue: int, n_t: int, bpd: int, snr_db: float,
                  n_frames: int, seed: int, sim: dict) -> dict:
    """ShardedSweep over a (n_ue, n_t) mesh: (errs, trials) and the
    backend of the "ue" group."""
    mesh = make_mesh(n_ue, n_t, device=device)
    sweep = ShardedSweep(_awgn(device, bpd * n_ue, sim), mesh, bpd)
    errs, trials = sweep.run_snr(snr_db, n_frames, seed=seed)
    return {"errs": errs, "trials": trials,
            "backend": dist.get_backend(sweep.group)}


def distributed_sweep(device, bpd: int, snr_db: float, n_frames: int,
                      seed: int, sim: dict, stream0: int = 0) -> tuple:
    """DistributedSweep.run_snr over every rank: (errs, trials, next)."""
    sweep = DistributedSweep(_awgn(device, bpd * dist.get_world_size(), sim),
                             batch_per_device=bpd)
    return sweep.run_snr(snr_db, n_frames, seed=seed, stream0=stream0)


class Preempted(Exception):
    """Raised in place of a trial, to stop a sweep as a preemption would."""


def bler_sweep(device, bpd: int, snrs, n_frames: int, sim: dict,
               seed: int = 0, ckpt_path: str | None = None,
               preempt_after: int | None = None):
    """distributed_bler_sweep's rows; with preempt_after, every rank's
    trial number preempt_after (from 0) raises instead, and the rows are
    None: what the checkpoint holds then is what a preempted job left."""
    def factory():
        s = _awgn(device, bpd * dist.get_world_size(), sim)
        if preempt_after is not None:
            calls, trial = itertools.count(), s.trial

            def trial_until(*args):
                if next(calls) == preempt_after:
                    raise Preempted
                return trial(*args)
            s.trial = trial_until
        return s

    try:
        return distributed_bler_sweep(factory, snrs, n_frames,
                                      batch_per_device=bpd, seed=seed,
                                      ckpt_path=ckpt_path, verbose=False)
    except Preempted:
        return None


def pss_correlate(device, n_ue: int, n_t: int, n_fft: int,
                  capture: np.ndarray) -> dict:
    """sharded_pss_correlate over a (n_ue, n_t) mesh on this rank's block
    of `capture` [B, L]: pos, nid2, peak (numpy), the halo's route, and
    the ms of a call and of its halo exchange (synced, after a first
    call)."""
    mesh = make_mesh(n_ue, n_t, device=device)
    block = capture.shape[1] // n_t
    i = mesh.get_local_rank("t")
    blk = torch.as_tensor(capture[:, i * block:(i + 1) * block],
                          device=device)
    corr = sharded_pss_correlate(mesh, n_fft, block)
    corr(blk)
    _sync(device)
    t0 = time.perf_counter()
    pos, nid2, peak = corr(blk)
    _sync(device)
    t1 = time.perf_counter()
    exchange_halo(blk[:, :n_fft], mesh)
    _sync(device)
    t2 = time.perf_counter()
    group = mesh.get_group("t")
    return {"pos": pos.cpu().numpy(), "nid2": nid2.cpu().numpy(),
            "peak": peak.cpu().numpy(), "ms": (t1 - t0) * 1e3,
            "halo_ms": (t2 - t1) * 1e3,
            "halo": ("none (n_t = 1)" if n_t == 1 else
                     "host copy (gloo send/recv)" if halo_via_host(blk, group)
                     else f"{blk.device.type} tensors"),
            "backend": dist.get_backend(group)}


def flagship(device, bpd: int, n_turbo_iter: int, snr_db: float) -> dict:
    """make_flagship_sharded's run(0): (errs, dci_miss, trials); then the
    ms of a step of this rank (synced, from the draw to the reduced
    counts) and of the step's all_reduce alone."""
    run = make_flagship_sharded(dist.get_world_size(), bpd, n_turbo_iter,
                                snr_db, device=device)
    errs, dci_miss, trials = run(0)
    _sync(device)
    t0 = time.perf_counter()
    run(0)
    _sync(device)
    t1 = time.perf_counter()
    out = torch.zeros(2, dtype=torch.int64, device=device)
    dist.all_reduce(out)
    _sync(device)
    t2 = time.perf_counter()
    return {"errs": errs, "dci_miss": dci_miss, "trials": trials,
            "step_ms": (t1 - t0) * 1e3, "all_reduce_ms": (t2 - t1) * 1e3,
            "backend": dist.get_backend()}


def entry_point(device) -> tuple:
    """graft_entry.entry's step once: (TBs decoded, bit errors)."""
    fn, args = entry(device=device)
    ok, bit_errs = fn(*args)
    return int(ok), int(bit_errs)
