"""Context-parallel (time-sharded) PSS matched filtering with a halo
exchange (counterpart of openair4g_tpu/parallel/timeshard.py).

Reference parity: the reference's "long sequence" is the IQ sample
stream, processed block-wise with explicit wraparound copies at block
edges (MODULATION/slot_fep.c:125-128) — SURVEY.md §5 maps this to
sharding the sample-time axis with a halo exchanged between neighbours.

Each rank of the mesh's "t" axis holds one contiguous time block of the
capture and FFT-correlates it against the 3 PSS replicas. It needs the
first n_fft samples of its right neighbour's block: the reference's
`ppermute` (i -> (i - 1) % n_t), here paired isend/irecv on the "t"
group. The global peak comes from an `all_gather` of each block's (max,
argmax).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import device_plan
from ..phy.sync import _replica_spectra_conj
from .mesh import axis_size


def halo_via_host(x, group) -> bool:
    """gloo's send/recv take CPU tensors only (its transport is handed the
    raw data pointer), so on a gloo group a device tensor crosses through
    a host copy."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def exchange_halo(head, mesh):
    """The reference's ppermute (i -> (i - 1) % n_t) on the "t" axis: this
    rank's `head` goes to its left neighbour, and the right neighbour's
    comes back. The complex samples travel as float32 pairs."""
    n_t = axis_size(mesh, "t")
    if n_t == 1:                 # the permutation maps the block to itself
        return head.clone()
    group, idx = mesh.get_group("t"), mesh.get_local_rank("t")
    buf = torch.view_as_real(head).contiguous()
    if halo_via_host(buf, group):
        buf = buf.cpu()
    got = torch.empty_like(buf)
    left = dist.get_global_rank(group, (idx - 1) % n_t)
    right = dist.get_global_rank(group, (idx + 1) % n_t)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, buf, left, group),
            dist.P2POp(dist.irecv, got, right, group)]):
        req.wait()
    return torch.view_as_complex(got.to(head.device))


def sharded_pss_correlate(mesh, n_fft: int, block_len: int):
    """Build the sharded correlator: fn(blk) with this rank's block [B,
    block_len] of a [B, n_t * block_len] capture (rank i of "t" holds
    samples i*block_len onwards) -> (pos [B], nid2 [B], peak [B]), the
    same on every rank: the argmax over the whole capture of
    |corr(t, replica)|^2 for the 3 PSS replicas, positions with a whole
    symbol after them only, the first block on a tie."""
    n_t = axis_size(mesh, "t")
    fft_len = 1 << (block_len + n_fft - 1).bit_length()

    def fn(blk):
        B, dev = blk.shape[0], blk.device
        idx = mesh.get_local_rank("t")
        ext = torch.cat([blk, exchange_halo(blk[:, :n_fft], mesh)], dim=-1)
        rf = torch.fft.fft(ext, n=fft_len, dim=-1)
        rep = device_plan(_replica_spectra_conj(n_fft, fft_len), dev)
        corr = torch.fft.ifft(rf[:, None, :] * rep, dim=-1)[..., :block_len]
        e = corr.abs() ** 2                                # [B, 3, bl]
        if idx == n_t - 1:       # the last block's tail has a wrapped halo
            e[..., block_len - n_fft:] = 0.0
        flat = e.reshape(B, -1)
        loc_arg = torch.argmax(flat, dim=-1)
        loc_max = flat.gather(1, loc_arg[:, None])[:, 0]
        group = mesh.get_group("t")
        all_max = [torch.empty_like(loc_max) for _ in range(n_t)]
        all_arg = [torch.empty_like(loc_arg) for _ in range(n_t)]
        dist.all_gather(all_max, loc_max, group=group)
        dist.all_gather(all_arg, loc_arg, group=group)
        all_max, all_arg = torch.stack(all_max), torch.stack(all_arg)
        win = torch.argmax(all_max, dim=0)                 # [B]
        arg = all_arg.gather(0, win[None, :])[0]
        nid2 = arg // block_len
        pos = win * block_len + arg % block_len
        return pos, nid2, all_max.gather(0, win[None, :])[0]

    return fn
