"""Device mesh for the Monte-Carlo and streaming axes (counterpart of
openair4g_tpu/parallel/mesh.py).

Reference parity: the reference's distributed axes (SURVEY.md §2.12) —
oaisim -M multicast data-parallelism over UE/channel instances (P4) and
the subframe sample-stream pipeline (P2) — map to a 2-D
torch.distributed DeviceMesh, one rank a device:

  * "ue": data parallel over UE channels / Monte-Carlo trials;
  * "t":  context parallel over time blocks of the sample stream, the
          halo (cyclic prefix / correlation tail) by paired send/recv.

The ranks are those of the default process group: `init_multihost` (or
any init_process_group) makes it; without one, a mesh of one rank gets a
one-process group of its own (an in-process store, no network). Several
ranks may share one card on gloo; NCCL takes one card a rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device


def default_backend(device) -> str:
    """nccl for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def ensure_process_group(device, backend: str | None = None) -> None:
    """A one-process group (rank 0 of 1, an in-process store) on `backend`
    (default_backend(device) if None), unless a group is there already."""
    if not dist.is_initialized():
        dist.init_process_group(backend or default_backend(device),
                                store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(n_ue: int | None = None, n_t: int = 1,
              device=None) -> DeviceMesh:
    """(ue, t) mesh over the first n_ue * n_t ranks, row-major. Defaults
    to every rank on the ue axis. `device` (None: the card) gives the
    mesh's device type."""
    dev = resolve_device(device)
    ensure_process_group(dev)
    world = dist.get_world_size()
    if n_ue is None:
        n_ue = world // n_t
    n = n_ue * n_t
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    return init_device_mesh(dev.type, (n_ue, n_t), mesh_dim_names=("ue", "t"))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]
