"""The DLSCH bit chain on the card around the turbo decode kernel:
wrappers of csrc/dlsch_encode.cu (transmit) and csrc/dlsch_decode.cu
(receive) and the plans they read.

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

`dematch` takes a round's LLRs e, and the earlier rounds' soft buffers,
to the new soft buffers of every code block in one buffer and to the
decode kernel's input of every (K, F) group in another, in one launch;
`tb_check` takes the decoded groups to the TB's bits and CRC flag in one
more. Their plain versions are DlschCodec.dematch_ref (ops/rate_match.
rate_match_rx and w_to_d_llr) and tb_check_ref (the payloads' cat and
ops/crc.crc_remainder).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..device import count_launch, device_plan
from ..tables.qpp import QPP_BY_K
from .crc import crc_packed_rows
from .rate_match import block_layout
from .segmentation import Z_MAX

CRC_CHUNK = 4096   # TB bits a block of tb_crc_kernel (CRC_CHUNK in the .cu)
MAX_PARTS = 32     # chunks the last code block's warp combines, one a lane
MAX_BLOCKS = 32    # code blocks a TB the decode side takes (MAX_BLOCKS in
                   # the .cu)


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
    each (rate_match.block_layout); raises ValueError for a TB the kernels
    do not take."""
    lay = block_layout(tbs, Es)
    C, Ks = lay.seg.C, lay.Ks
    n_part = -(-tbs // CRC_CHUNK)
    if not 0 < n_part <= MAX_PARTS:
        raise ValueError(f"dlsch encode: TBS {tbs} outside (0, "
                         f"{MAX_PARTS * CRC_CHUNK}]")
    doffs = tuple(int(x) for x in np.cumsum([0] + [3 * (K + 4)
                                                   for K in Ks])[:-1])
    desc, pos = [], 0
    for r, (K, F, n) in enumerate(zip(Ks, lay.Fs, lay.payload)):
        last = r == C - 1
        desc.append((K, F, *QPP_BY_K[K], pos, n - 24 if last else n,
                     doffs[r], int(last)))
        pos += n
    eoffs = np.cumsum([0] + list(Es))[:-1]
    head = np.asarray([(K, doffs[r], eoffs[r], Es[r])
                       for r, K in enumerate(Ks)], np.int64).ravel()
    select = tuple(np.concatenate([head] + [m.e_src for m in maps])
                   .astype(np.int32) for maps in lay.maps_by_rv)
    return EncodePlan(tbs=tbs, C=C, Ks=Ks, Es=tuple(Es), doffs=doffs,
                      dtot=3 * sum(Ks) + 12 * C, G=sum(Es), n_part=n_part,
                      desc=np.asarray(desc, np.int32), select=select)


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


# ------------------------------------------------------------ receive --

# A code block's row of DecodePlan.desc (the enum in csrc/dlsch_decode.cu).
(D_K, D_F, D_E, D_EOFF, D_L, D_WOFF, D_DOFF, D_MOFF, D_GROUP, D_IDX, D_BOFF,
 D_NPAY, D_ROFF) = range(13)
D_FIELDS = D_ROFF + 4


@dataclass(frozen=True)
class DecodePlan:
    """The receive kernels' plan of one (TBS, per-block E) configuration.

    Block r's soft buffer holds Ls[r] order-space LLRs at `woffs[r]` of a
    [B, wtot] row. The decode kernel takes each (K, F) group of `groups`
    (K, F, its blocks), in the order of its first block, as one [n B, 3,
    K + 4] tensor, block-major; group g starts at B goffs[g] of the d
    buffer, B drow floats in all. `desc` int32 [C, D_FIELDS], a block a
    row: K, F, E, its offset in e, L, its w offset, the start of its rows
    of d (B times it, each row 3 (K + 4) long), its map's offset in
    `maps`, its group, its place there, its payload's offset in the TB's
    bits and length, and r_off at rv 0-3. `maps`: each group's
    d_from_order, concatenated. `smem`: the largest L's bytes."""
    tbs: int
    C: int
    Ks: tuple
    Es: tuple
    G: int
    Ls: tuple
    woffs: tuple
    wtot: int
    groups: tuple
    goffs: tuple
    drow: int
    desc: np.ndarray
    maps: np.ndarray
    smem: int


@functools.lru_cache(maxsize=None)
def decode_plan(tbs: int, Es: tuple) -> DecodePlan:
    """The receive plan of a TB of `tbs` bits whose code blocks were sent
    in Es[r] bits each (rate_match.block_layout); raises ValueError for a
    TB the kernels do not take."""
    lay = block_layout(tbs, Es)
    C, Ks, groups, maps = lay.seg.C, lay.Ks, lay.groups, lay.maps_by_rv
    if C > MAX_BLOCKS:
        raise ValueError(f"dlsch decode: {C} code blocks, more than "
                         f"{MAX_BLOCKS}")
    sizes = [len(rs) * 3 * (K + 4) for K, _, rs in groups]
    goffs = tuple(int(x) for x in np.cumsum([0] + sizes)[:-1])
    moffs = np.cumsum([0] + [3 * (K + 4) for K, _, _ in groups])[:-1]
    Ls = tuple(m.L for m in maps[0])
    woffs = tuple(int(x) for x in np.cumsum((0,) + Ls)[:-1])
    eoffs = np.cumsum((0,) + tuple(Es))[:-1]
    boffs = np.cumsum((0,) + lay.payload)[:-1]
    desc = np.zeros((C, D_FIELDS), np.int64)
    for g, (K, F, rs) in enumerate(groups):
        for i, r in enumerate(rs):
            desc[r, :D_ROFF] = (K, F, Es[r], eoffs[r], Ls[r], woffs[r],
                                goffs[g] + i * 3 * (K + 4), moffs[g], g, i,
                                boffs[r], lay.payload[r])
            desc[r, D_ROFF:] = [m[r].r_off for m in maps]
    return DecodePlan(
        tbs=tbs, C=C, Ks=Ks, Es=tuple(Es), G=sum(Es), Ls=Ls,
        woffs=woffs, wtot=sum(Ls), groups=groups, goffs=goffs,
        drow=sum(sizes), desc=desc.astype(np.int32),
        maps=np.concatenate([maps[0][rs[0]].d_from_order
                             for _, _, rs in groups]).astype(np.int32),
        smem=4 * max(Ls))


def w_views(w, p: DecodePlan) -> list:
    """Each code block's soft buffer [B, L] as a view of dematch's w."""
    return list(w.split(p.Ls, dim=1))


def group_inputs(d, p: DecodePlan, B: int) -> list:
    """Each (K, F) group's decode input [n B, 3, K + 4], in the plan's
    order, as a view of dematch's d."""
    return [d[B * o:B * o + len(rs) * B * 3 * (K + 4)].view(-1, 3, K + 4)
            for (K, _, rs), o in zip(p.groups, p.goffs)]


def dematch(e_llr, w_old, p: DecodePlan, rv: int):
    """The rate de-matching of redundancy version rv with the HARQ
    combining, on a CUDA device, in one launch, no host sync: e_llr
    float32 [B, >= G] -> (w float32 [B, wtot], every code block's new soft
    buffer, w_views() splits it; d float32 [B drow], every group's decode
    input, group_inputs() splits it). `w_old`: None, or each block's soft
    buffer of the earlier rounds, float32 tensors that broadcast to
    [B, L], read where they lie and never written."""
    dev = e_llr.device
    if dev.type != "cuda":
        raise ValueError(f"dlsch dematch: e_llr on {dev}; CUDA required")
    if e_llr.dtype != torch.float32:
        raise TypeError(f"dlsch dematch: float32 LLRs required, not "
                        f"{e_llr.dtype}")
    if e_llr.dim() != 2 or e_llr.shape[1] < p.G:
        raise ValueError(f"dlsch dematch: e_llr {tuple(e_llr.shape)} must "
                         f"be [B, {p.G}]")
    if not 0 <= rv <= 3:
        raise ValueError(f"dlsch dematch: rv {rv}")
    if e_llr.stride(1) != 1:
        e_llr = e_llr.contiguous()
    B = e_llr.shape[0]
    old = []
    if w_old is not None:
        if len(w_old) != p.C:
            raise ValueError(f"dlsch dematch: {len(w_old)} soft buffers, "
                             f"not {p.C}")
        for x, L in zip(w_old, p.Ls):
            if x.dtype != torch.float32 or x.device != dev:
                raise ValueError(f"dlsch dematch: a soft buffer of "
                                 f"{x.dtype} on {x.device}, not float32 on "
                                 f"{dev}")
            if x.shape != (B, L):
                x = x.expand(B, L)
            old.append(x if x.stride(1) == 1 else x.contiguous())
    w = torch.empty(B, p.wtot, dtype=torch.float32, device=dev)
    d = torch.empty(B * p.drow, dtype=torch.float32, device=dev)
    if B == 0:
        return w, d
    ptrs = (ctypes.c_longlong * (2 * p.C))(
        *[v for x in old for v in (x.data_ptr(), x.stride(0))])
    err = kernels.load().dlsch_dematch_launch(
        e_llr.data_ptr(), e_llr.stride(0), ptrs, int(bool(old)), w.data_ptr(),
        p.wtot, d.data_ptr(), device_plan(p.desc, dev).data_ptr(),
        device_plan(p.maps, dev).data_ptr(), p.C, B, rv, p.smem,
        kernels.stream_of(e_llr))
    kernels.check(err, "dlsch_dematch")
    count_launch("dlsch_dematch", (B, p.tbs, p.Es, rv, bool(old)))
    return w, d


def tb_check(decoded, p: DecodePlan):
    """The TB's bits and CRC flag from each group's decode, (bits [n B, K]
    int32, done [n B] bool) in the plan's order, on a CUDA device, in one
    launch: (b_hat int32 [B, TBS + 24], the payloads of the blocks in
    turn; tb_ok bool [B], every block's flag and the CRC24A)."""
    if len(decoded) != len(p.groups):
        raise ValueError(f"dlsch tb_check: {len(decoded)} groups, not "
                         f"{len(p.groups)}")
    dev = decoded[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"dlsch tb_check: bits on {dev}; CUDA required")
    B = decoded[0][1].shape[0] // len(p.groups[0][2])
    for (bits, done), (K, _, rs) in zip(decoded, p.groups):
        if (bits.dtype != torch.int32 or bits.shape != (len(rs) * B, K)
                or done.dtype != torch.bool or done.shape != (len(rs) * B,)
                or not (bits.is_contiguous() and done.is_contiguous())
                or bits.device != dev or done.device != dev):
            raise ValueError(f"dlsch tb_check: a group's bits "
                             f"{tuple(bits.shape)} {bits.dtype} and flags "
                             f"{tuple(done.shape)} {done.dtype}, not "
                             f"contiguous int32 [{len(rs) * B}, {K}] and "
                             f"bool [{len(rs) * B}] on {dev}")
    nb = p.tbs + 24
    b_hat = torch.empty(B, nb, dtype=torch.int32, device=dev)
    tb_ok = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return b_hat, tb_ok
    n = len(decoded)
    bits_p = (ctypes.c_void_p * n)(*[b.data_ptr() for b, _ in decoded])
    done_p = (ctypes.c_void_p * n)(*[f.data_ptr() for _, f in decoded])
    err = kernels.load().dlsch_tb_check_launch(
        bits_p, done_p, n, device_plan(p.desc, dev).data_ptr(), p.C,
        device_plan(crc_packed_rows(nb, "crc24a"), dev).data_ptr(), nb,
        b_hat.data_ptr(), tb_ok.data_ptr(), B, kernels.stream_of(b_hat))
    kernels.check(err, "dlsch_tb_check")
    count_launch("dlsch_tb_check", (B, p.tbs, p.Es))
    return b_hat, tb_ok
