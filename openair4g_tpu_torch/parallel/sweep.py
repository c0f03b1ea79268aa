"""Data-parallel BLER sweep over a device mesh (counterpart of
openair4g_tpu/parallel/sweep.py: shard_map + psum there, rows a rank +
all_reduce here).

Reference parity: distributed oaisim/dlsim — the reference shards eNB/UE
instances across machines over IP multicast and aggregates frame
statistics at the master (SIMULATION/ETH_TRANSPORT/emu_transport.c,
multicast_link.c; launch_sim.sh PBS sweeps). Here the Monte-Carlo trial
batch is sharded over the mesh's "ue" axis and the error count is
summed with `all_reduce` over that axis' group.

Determinism: every rank draws the whole global batch of a chunk from the
point's generator and keeps its rows (utils/rng.py), so the sharded run
equals the one-process `run_snr` at the same global batch, error for
error, provided the sim's `trial` on a block of rows gives those rows of
its result on the whole batch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils.rng import draw_stream, fast_forward, rank_rows
from .mesh import axis_size


class ShardedSweep:
    """Wraps a simulator with `draw(generator)` (its cfg.batch trials)
    and `trial(*draw, n0)` (ok [b] bool, or a tuple whose first element
    is ok) into a mesh-sharded accumulator returning globally reduced
    (n_err, n_trials). The sim's cfg.batch is the global batch,
    batch_per_device times the size of the mesh's `axis`; ranks along the
    other axis compute the same sums."""

    def __init__(self, sim, mesh, batch_per_device: int, axis: str = "ue"):
        self.sim = sim
        self.mesh = mesh
        self.bpd = batch_per_device
        self.n_dev = axis_size(mesh, axis)
        self.batch = self.bpd * self.n_dev
        if sim.cfg.batch != self.batch:
            raise ValueError(f"the sim draws batches of {sim.cfg.batch}; "
                             f"the mesh's {self.n_dev} x {self.bpd} trials "
                             f"need {self.batch}")
        self.index = mesh.get_local_rank(axis)
        self.group = mesh.get_group(axis)

    def _errors(self, draws, n0) -> int:
        ok = self.sim.trial(*rank_rows(draws, self.index, self.n_dev), n0)
        if isinstance(ok, tuple):
            ok = ok[0]
        err = (~ok).sum().to(torch.int64).reshape(1)
        dist.all_reduce(err, group=self.group)
        return int(err)

    def _run(self, snr_db: float, n_frames: int, seed: int,
             stream0: int) -> tuple:
        """(errs, trials, next chunk) over ceil(n_frames / batch) chunks
        from chunk stream0 of the point's draw stream."""
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        gen = draw_stream(seed, self.sim.device)
        fast_forward(self.sim, gen, stream0)
        errs = trials = 0
        n_chunks = -(-n_frames // self.batch)
        for _ in range(n_chunks):
            errs += self._errors(self.sim.draw(gen), n0)
            trials += self.batch
        return errs, trials, stream0 + n_chunks

    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0):
        """(errs, trials) at one SNR, the same on every rank."""
        return self._run(snr_db, n_frames, seed, 0)[:2]
