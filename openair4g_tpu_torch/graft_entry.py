"""Entry points of the port (counterpart of __graft_entry__.py): a
one-device forward step, the flagship sharded over ranks, and the
multi-rank dry run.

    from openair4g_tpu_torch.graft_entry import entry
    fn, args = entry()                 # the card; entry(device="cpu")
    ok, bit_errs = fn(*args)

`make_flagship_sharded`, `flagship_sharded_step` and `dryrun_multichip`
run in every rank of an initialised process group (see
parallel/launch.spawn), or in one process, which is then a mesh of one.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .config import FrameParms
from .device import resolve_device
from .parallel import ShardedSweep, make_mesh, sharded_pss_correlate
from .parallel.mesh import axis_size, ensure_process_group
from .phy.sync import pss_time_replica
from .sim.dlsim import (DlsimAwgn, DlsimConfig, DlsimFading,
                        DlsimFadingConfig)
from .utils.rng import draw_stream, fast_forward, rank_rows


def entry(device=None):
    """(fn, example_args): one batched PDSCH subframe trial of the
    flagship pipeline (TX -> AWGN -> RX -> turbo decode): DlsimAwgn, MCS
    4, 25 PRB, batch 8, 4 iterations, -0.6 dB, on draws from seed 0.
    fn(*args) -> (TBs decoded, bit errors)."""
    sim = DlsimAwgn(DlsimConfig(mcs=4, n_rb=25, batch=8, n_turbo_iter=4),
                    device=device)

    def fn(tb_bits, noise_normals, n0):
        res = sim.trial(tb_bits, noise_normals, n0)
        return res.ok.sum(), res.bit_errs.sum()

    tb, noise = sim.draw(draw_stream(0, sim.device))
    return fn, (tb, noise, np.float32(10.0 ** (-0.6 / 10)))


def make_flagship_sharded(mesh_or_world, batch_per_device: int = 1,
                          n_turbo_iter: int = 2, snr_db: float = 26.0,
                          device=None):
    """The flagship's round-0 trial (DlsimFading: 100 PRB, MCS 26, EVA, 1
    RX, joint estimation, the DCI blind-decoded) sharded over the mesh's
    "ue" axis (a mesh, or a world size for a (world, 1) mesh). Returns
    run(stream=0) -> (errs, dci_miss, trials), the same on every rank:
    each rank draws chunk `stream` of seed 0 at the global batch, runs
    round 0 on its rows and sums the TB errors and DCI misses with
    all_reduce over "ue"."""
    dev = resolve_device(device)
    mesh = (make_mesh(n_ue=mesh_or_world, n_t=1, device=dev)
            if isinstance(mesh_or_world, int) else mesh_or_world)
    n_ue, row = axis_size(mesh, "ue"), mesh.get_local_rank("ue")
    group = mesh.get_group("ue")
    B = batch_per_device * n_ue
    sim = DlsimFading(DlsimFadingConfig(
        mcs=26, n_rb=100, channel="EVA", n_rx=1, n_harq_rounds=1, batch=B,
        est_mode="joint", n_turbo_iter=n_turbo_iter), device=dev)
    n0 = np.float32(10.0 ** (-snr_db / 10.0))
    W, ev = sim.wiener(snr_db), sim.err_var(snr_db)

    def run(stream: int = 0):
        gen = draw_stream(0, sim.device)
        fast_forward(sim, gen, stream)
        tb, taps, noise = rank_rows(sim.draw(gen), row, n_ue)
        res, _ = sim.round(0, tb, sim.dlsch.encode_to_d(tb), taps[0],
                           noise[0], n0, W, ev)
        out = torch.stack([(~res.ok).sum(), (~res.dci_ok).sum()]).to(
            torch.int64)
        dist.all_reduce(out, group=group)
        return int(out[0]), int(out[1]), B

    return run


def flagship_sharded_step(mesh_or_world, batch_per_device: int = 1,
                          n_turbo_iter: int = 2, snr_db: float = 26.0,
                          device=None):
    """One-shot convenience wrapper around make_flagship_sharded."""
    return make_flagship_sharded(mesh_or_world, batch_per_device,
                                 n_turbo_iter, snr_db, device)()


def dryrun_multichip(world: int, device=None) -> None:
    """The reference's three multi-device checks, in each of `world`
    ranks: the PDSCH step sharded over "ue" with all_reduced errors; the
    PSS correlation sharded over "t" with the send/recv halo, peaks
    inside a block and straddling the halo; the 20 MHz flagship sharded
    over "ue", every TB and DCI decoded. Rank 0 prints."""
    dev = resolve_device(device)
    ensure_process_group(dev)
    if dist.get_world_size() != world:
        raise RuntimeError(f"dryrun_multichip({world}) runs in {world} "
                           f"ranks; the group has {dist.get_world_size()}")
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    n_t = 2 if world % 2 == 0 else 1
    mesh = make_mesh(n_ue=world // n_t, n_t=n_t, device=dev)

    # 1) DP: the PDSCH trial sharded over "ue", all_reduced errors
    batch = 2 * axis_size(mesh, "ue")
    sim = DlsimAwgn(DlsimConfig(mcs=0, n_rb=6, batch=batch, n_turbo_iter=2),
                    device=dev)
    errs, trials = ShardedSweep(sim, mesh, batch_per_device=2).run_snr(
        2.0, batch)
    say(f"dryrun_multichip({world}): DP PDSCH step ran, "
        f"{trials - errs}/{trials} TBs decoded (all_reduce over 'ue')")

    # 2) SP: time-sharded PSS correlation with the halo over "t"
    fp = FrameParms(n_rb=6)
    block = 1024
    corr = sharded_pss_correlate(mesh, fp.n_fft, block)
    L = block * n_t
    r = np.zeros((2, L), np.complex64)
    true_pos = [block - 37, (L - fp.n_fft) // 2]   # one straddles the halo
    for b, tp in enumerate(true_pos):
        r[b, tp:tp + fp.n_fft] = pss_time_replica(2, fp.n_fft)
    i = mesh.get_local_rank("t")
    pos, nid2, _ = corr(torch.as_tensor(r[:, i * block:(i + 1) * block],
                                        device=dev))
    assert pos.tolist() == true_pos, (pos, true_pos)
    assert (nid2 == 2).all()
    say(f"dryrun_multichip({world}): time-sharded PSS correlation found "
        f"peaks {pos.tolist()} across the halo")

    # 3) the flagship (20 MHz, MCS 26, EVA, joint CE, PDCCH, 11 code
    # blocks) sharded over "ue"
    errs, dci_miss, trials = flagship_sharded_step(world, device=dev)
    assert errs == 0 and dci_miss == 0, (errs, dci_miss)
    say(f"dryrun_multichip({world}): FLAGSHIP 100-PRB MCS26 estimated-CE "
        f"step sharded over 'ue' — {trials - errs}/{trials} TBs decoded, "
        "0 DCI misses (all_reduce over 'ue')")
