"""The DLSCH transmit bit chain on the card: wrappers of
csrc/dlsch_encode.cu and the plan they read.

`encode` takes a TB's bits to the d streams of all its code blocks in one
int32 buffer, in two launches: the TB's CRC24A in chunks of CRC_CHUNK
bits, then one warp a (row, code block) for the segmentation with its
filler bits, the CRC24B, both RSC encoders over the QPP interleaver, the
trellis termination and the tail interlacing. `select` takes that buffer
to the e bits of one redundancy version in one launch, through every
block's e_src map concatenated at plan time. Their plain versions are
phy/pdsch.DlschCodec's CPU path (ops/crc.crc_device, ops/turbo.
turbo_encode_device, ops/rate_match.rate_match_tx), which they equal bit
for bit; the codec chooses by the tensor's device.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..device import count_launch, device_plan
from ..tables.qpp import QPP_BY_K
from .crc import crc_packed_rows
from .rate_match import compute_ncb, make_rate_match_maps
from .segmentation import Z_MAX, segment_tb

CRC_CHUNK = 4096   # TB bits a block of tb_crc_kernel (CRC_CHUNK in the .cu)
MAX_PARTS = 32     # chunks the last code block's warp combines, one a lane


@dataclass(frozen=True)
class EncodePlan:
    """The kernels' plan of one (TBS, per-block E) configuration.

    `desc` int32 [C, 8], a code block a row: K, F, f1 and f2 of its QPP
    interleaver, its first TB bit, how many TB bits it carries (the last
    block's CRC24A not counted), its offset in a row of d, and whether it
    is the last block. d's row holds block r's 3 (K + 4) stream bits at
    `doffs[r]`, `dtot` in all. Block r sends Es[r] bits, G in all.
    `select[rv]` int32 [4 C + G]: each block's (K, d offset, e offset, E),
    then every block's e_src (positions in its d streams) in e's order."""
    tbs: int
    C: int
    Ks: tuple
    Es: tuple
    doffs: tuple
    dtot: int
    G: int
    n_part: int
    desc: np.ndarray
    select: tuple


@functools.lru_cache(maxsize=None)
def plan(tbs: int, Es: tuple) -> EncodePlan:
    """The plan of a TB of `tbs` bits whose code blocks send Es[r] bits
    each (36.212 segmentation of tbs + 24 bits, soft buffers of
    rate_match.compute_ncb); raises ValueError for a TB the kernels do not
    take."""
    seg = segment_tb(tbs + 24)
    C, Ks = seg.C, seg.block_sizes
    if len(Es) != C:
        raise ValueError(f"dlsch encode: {len(Es)} E sizes for {C} blocks")
    n_part = -(-tbs // CRC_CHUNK)
    if not 0 < n_part <= MAX_PARTS:
        raise ValueError(f"dlsch encode: TBS {tbs} outside (0, "
                         f"{MAX_PARTS * CRC_CHUNK}]")
    L = 24 if C > 1 else 0
    doffs = tuple(int(x) for x in np.cumsum([0] + [3 * (K + 4)
                                                   for K in Ks])[:-1])
    desc, pos = [], 0
    for r, K in enumerate(Ks):
        F = seg.F if r == 0 else 0
        n = K - L - F
        last = r == C - 1
        desc.append((K, F, *QPP_BY_K[K], pos, n - 24 if last else n,
                     doffs[r], int(last)))
        pos += n
    select = []
    for rv in range(4):
        maps = [make_rate_match_maps(K, seg.F if r == 0 else 0, rv, Es[r],
                                     compute_ncb(K, C))
                for r, K in enumerate(Ks)]
        eoffs = np.cumsum([0] + list(Es))[:-1]
        head = [(K, doffs[r], eoffs[r], Es[r]) for r, K in enumerate(Ks)]
        select.append(np.concatenate(
            [np.asarray(head, np.int64).ravel()]
            + [m.e_src for m in maps]).astype(np.int32))
    return EncodePlan(tbs=tbs, C=C, Ks=tuple(Ks), Es=tuple(Es), doffs=doffs,
                      dtot=3 * sum(Ks) + 12 * C, G=sum(Es), n_part=n_part,
                      desc=np.asarray(desc, np.int32), select=tuple(select))


def views(d, p: EncodePlan) -> list:
    """Each code block's streams [B, 3 (K + 4)] as a view of encode's d."""
    return list(d.split([3 * (K + 4) for K in p.Ks], dim=1))


def encode(tb_bits, p: EncodePlan):
    """tb_bits [B, TBS] {0, 1} on a CUDA device -> d int32 [B, p.dtot],
    every code block's d0/d1/d2 streams (views() splits it); two launches,
    no host sync."""
    dev = tb_bits.device
    if dev.type != "cuda":
        raise ValueError(f"dlsch encode: tb_bits on {dev}; CUDA required")
    if tb_bits.dim() != 2 or tb_bits.shape[1] != p.tbs:
        raise ValueError(f"dlsch encode: tb_bits {tuple(tb_bits.shape)} "
                         f"must be [B, {p.tbs}]")
    tb = tb_bits.to(torch.int32).contiguous()
    B = tb.shape[0]
    d = torch.empty(B, p.dtot, dtype=torch.int32, device=dev)
    if B == 0:
        return d
    part = torch.empty(B, p.n_part, dtype=torch.int32, device=dev)
    rows_a = device_plan(crc_packed_rows(p.tbs, "crc24a"), dev)
    rows_b = device_plan(crc_packed_rows(Z_MAX - 24, "crc24b"), dev)
    err = kernels.load().dlsch_encode_launch(
        tb.data_ptr(), p.tbs, rows_a.data_ptr(), part.data_ptr(), p.n_part,
        device_plan(p.desc, dev).data_ptr(), p.C, int(p.C > 1),
        rows_b.data_ptr(), d.data_ptr(), p.dtot, B, kernels.stream_of(tb))
    kernels.check(err, "dlsch_encode")
    count_launch("dlsch_encode", (B, p.tbs, p.Es))
    return d


def _base(d_flats, p: EncodePlan) -> int:
    """The address of row 0 of the buffer the streams are views of, as
    views() lays them out, 16-byte aligned (the select kernel reads 16
    bytes a lane); raises ValueError where they are not."""
    d0 = d_flats[0]
    base = d0.data_ptr()
    rows = d0.shape[0] > 1
    if d0.dtype != torch.int32 or base % 16 or any(
            x.data_ptr() != base + 4 * o or x.stride(1) != 1
            or (rows and x.stride(0) != p.dtot)
            for x, o in zip(d_flats, p.doffs)):
        raise ValueError("dlsch select: the streams must be views() of one "
                         "encode's d")
    return base


def select(d_flats, p: EncodePlan, rv: int):
    """The e bits int32 [B, G] of redundancy version rv from every code
    block's streams [B, 3 (K + 4)] on a CUDA device, views() of encode's d,
    read where they lie: one launch."""
    if len(d_flats) != p.C:
        raise ValueError(f"dlsch select: {len(d_flats)} blocks, not {p.C}")
    B, dev = d_flats[0].shape[0], d_flats[0].device
    if dev.type != "cuda":
        raise ValueError(f"dlsch select: streams on {dev}; CUDA required")
    for x, K in zip(d_flats, p.Ks):
        if x.shape != (B, 3 * (K + 4)) or x.device != dev:
            raise ValueError(f"dlsch select: streams {tuple(x.shape)} on "
                             f"{x.device}, not [{B}, {3 * (K + 4)}] on {dev}")
    e = torch.empty(B, p.G, dtype=torch.int32, device=dev)
    if B == 0:
        return e
    base = _base(d_flats, p)
    err = kernels.load().dlsch_select_launch(
        base, p.dtot, device_plan(p.select[rv], dev).data_ptr(), p.C,
        e.data_ptr(), p.G, B, kernels.stream_of(e))
    kernels.check(err, "dlsch_select")
    count_launch("dlsch_select", (B, p.tbs, p.Es, rv))
    return e
