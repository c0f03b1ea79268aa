"""DCI payload formats of the multi-antenna downlink, 36.212 §5.3.3.1
(counterpart of openair4g_tpu/phy/dci_formats.py): format 1 (type-0 RBG
bitmap), 2A (open-loop spatial multiplexing), 2 (closed loop, with the
precoding information), 1B (rank-1 closed loop) and 1D (MU-MIMO). Fields
are packed MSB first, as format 1A in phy/pdcch.py; `unpack_*` parses a
payload back into its fields.
"""
from __future__ import annotations

import math

import numpy as np


def _pack(fields) -> np.ndarray:
    bits = []
    for val, width in fields:
        if not 0 <= val < (1 << width):
            raise ValueError(f"field value {val} does not fit {width} bits")
        bits += [(val >> (width - 1 - i)) & 1 for i in range(width)]
    return np.asarray(bits, np.int8)


class _Reader:
    def __init__(self, bits):
        self.bits = np.asarray(bits, np.int64)
        self.pos = 0

    def take(self, w: int) -> int:
        v = 0
        for _ in range(w):
            v = (v << 1) | int(self.bits[self.pos])
            self.pos += 1
        return v


def _riv(n_rb: int, rb_start: int, n_prb: int) -> int:
    if (n_prb - 1) <= n_rb // 2:
        return n_rb * (n_prb - 1) + rb_start
    return n_rb * (n_rb - n_prb + 1) + (n_rb - 1 - rb_start)


def _unriv(riv: int, n_rb: int) -> tuple:
    lcrb = riv // n_rb + 1
    rb_start = riv % n_rb
    if rb_start + lcrb > n_rb:
        lcrb = n_rb - lcrb + 2
        rb_start = n_rb - 1 - rb_start
    return rb_start, lcrb


def _riv_bits(n_rb: int) -> int:
    return math.ceil(math.log2(n_rb * (n_rb + 1) / 2))


def n_rbg(n_rb_dl: int) -> tuple:
    """(resource-block-group count, RBG size P) for type-0 allocation,
    36.213 Table 7.1.6.1-1: P = 1/2/3/4 for <=10/<=26/<=63/<=110 RB."""
    p = 1 if n_rb_dl <= 10 else 2 if n_rb_dl <= 26 else \
        3 if n_rb_dl <= 63 else 4
    return -(-n_rb_dl // p), p


# ------------------------------------------------------------- format 1 --

def dci_format1_size(n_rb_dl: int, tdd: bool = False) -> int:
    nbg, _ = n_rbg(n_rb_dl)
    return nbg + 5 + (4 if tdd else 3) + 1 + 2 + 2 + (2 if tdd else 0)


def pack_dci_format1(n_rb_dl: int, rbg_bitmap: int, mcs: int, harq_pid: int,
                     ndi: int, rv: int, tpc: int = 0,
                     tdd: bool = False, dai: int = 0) -> np.ndarray:
    nbg, _ = n_rbg(n_rb_dl)
    fields = [(rbg_bitmap, nbg), (mcs, 5), (harq_pid, 4 if tdd else 3),
              (ndi, 1), (rv, 2), (tpc, 2)]
    if tdd:
        fields.append((dai, 2))
    return _pack(fields)


def unpack_dci_format1(bits: np.ndarray, n_rb_dl: int,
                       tdd: bool = False) -> dict:
    nbg, p = n_rbg(n_rb_dl)
    r = _Reader(bits)
    bitmap = r.take(nbg)
    rbs = []
    for g in range(nbg):
        if (bitmap >> (nbg - 1 - g)) & 1:
            rbs += [g * p + i for i in range(p) if g * p + i < n_rb_dl]
    out = dict(rbg_bitmap=bitmap, rb_list=tuple(rbs), mcs=r.take(5),
               harq_pid=r.take(4 if tdd else 3), ndi=r.take(1),
               rv=r.take(2), tpc=r.take(2))
    if tdd:
        out["dai"] = r.take(2)
    return out


# ------------------------------------------------------------ format 2A --

def dci_format2a_size(n_rb_dl: int, n_tx: int = 2,
                      tdd: bool = False) -> int:
    nbg, _ = n_rbg(n_rb_dl)
    precoding = 0 if n_tx == 2 else 2       # 36.212 Table 5.3.3.1.5A
    return nbg + 2 + (4 if tdd else 3) + 1 + (5 + 1 + 2) * 2 + precoding \
        + (2 if tdd else 0)


def _format2_fields(n_rb_dl, rbg_bitmap, harq_pid, tb_swap, mcs1, ndi1, rv1,
                    mcs2, ndi2, rv2, tpc, tdd, dai) -> list:
    nbg, _ = n_rbg(n_rb_dl)
    fields = [(rbg_bitmap, nbg), (tpc, 2)]
    if tdd:
        fields.append((dai, 2))
    return fields + [(harq_pid, 4 if tdd else 3), (tb_swap, 1),
                     (mcs1, 5), (ndi1, 1), (rv1, 2),
                     (mcs2, 5), (ndi2, 1), (rv2, 2)]


def pack_dci_format2a(n_rb_dl: int, rbg_bitmap: int, harq_pid: int,
                      tb_swap: int, mcs1: int, ndi1: int, rv1: int,
                      mcs2: int, ndi2: int, rv2: int, tpc: int = 0,
                      n_tx: int = 2, tdd: bool = False,
                      dai: int = 0) -> np.ndarray:
    fields = _format2_fields(n_rb_dl, rbg_bitmap, harq_pid, tb_swap, mcs1,
                             ndi1, rv1, mcs2, ndi2, rv2, tpc, tdd, dai)
    if n_tx == 4:
        fields.append((0, 2))
    return _pack(fields)


def unpack_dci_format2a(bits: np.ndarray, n_rb_dl: int,
                        n_tx: int = 2, tdd: bool = False) -> dict:
    nbg, _ = n_rbg(n_rb_dl)
    r = _Reader(bits)
    out = dict(rbg_bitmap=r.take(nbg), tpc=r.take(2))
    if tdd:
        out["dai"] = r.take(2)
    out.update(harq_pid=r.take(4 if tdd else 3), tb_swap=r.take(1))
    for q in (1, 2):
        out[f"mcs{q}"] = r.take(5)
        out[f"ndi{q}"] = r.take(1)
        out[f"rv{q}"] = r.take(2)
    return out


# ------------------------------------------------------------- format 2 --
# Format 2A plus the precoding information (36.212 Table 5.3.3.1.5-4:
# 3 bits for 2 TX ports, 6 for 4). With 2 ports and both codewords on,
# 0 is the identity and 1/2 are the rank-2 codebook indices; with one
# codeword, 0..3 are the rank-1 codebook indices.

def dci_format2_precoding_bits(n_tx: int = 2) -> int:
    return 3 if n_tx == 2 else 6


def dci_format2_size(n_rb_dl: int, n_tx: int = 2,
                     tdd: bool = False) -> int:
    return dci_format2a_size(n_rb_dl, n_tx=4 if n_tx == 4 else 2,
                             tdd=tdd) + \
        dci_format2_precoding_bits(n_tx) - (0 if n_tx == 2 else 2)


def pack_dci_format2(n_rb_dl: int, rbg_bitmap: int, harq_pid: int,
                     tb_swap: int, mcs1: int, ndi1: int, rv1: int,
                     mcs2: int, ndi2: int, rv2: int, precoding: int,
                     tpc: int = 0, n_tx: int = 2, tdd: bool = False,
                     dai: int = 0) -> np.ndarray:
    fields = _format2_fields(n_rb_dl, rbg_bitmap, harq_pid, tb_swap, mcs1,
                             ndi1, rv1, mcs2, ndi2, rv2, tpc, tdd, dai)
    return _pack(fields + [(precoding, dci_format2_precoding_bits(n_tx))])


def unpack_dci_format2(bits: np.ndarray, n_rb_dl: int,
                       n_tx: int = 2, tdd: bool = False) -> dict:
    out = unpack_dci_format2a(bits, n_rb_dl, n_tx=2, tdd=tdd)
    r = _Reader(bits)
    r.pos = dci_format2a_size(n_rb_dl, n_tx=2, tdd=tdd)
    pinfo = r.take(dci_format2_precoding_bits(n_tx))
    two_cw = out["mcs2"] != 0 or out["rv2"] != 0   # codeword 2 enabled
    out.update(precoding_info=pinfo, rank=2 if two_cw else 1, pmi=pinfo)
    return out


# --------------------------------------------------------- formats 1B/1D --
# Rank-1 closed-loop grants (1B: TM6; 1D: TM5 MU-MIMO with the
# downlink-power-offset flag), 36.212 §5.3.3.1.3/3A: RIV (type-2)
# allocation plus TPMI. The 2-port 1B pads one bit against a size clash.

def _tpmi_bits(n_tx: int) -> int:
    return 2 if n_tx == 2 else 4


def dci_format1b_size(n_rb_dl: int, n_tx: int = 2) -> int:
    base = 1 + _riv_bits(n_rb_dl) + 5 + 3 + 1 + 2 + 2 + _tpmi_bits(n_tx) + 1
    return base + (1 if n_tx == 2 else 0)


def _format1bd_fields(n_rb_dl, rb_start, n_prb, mcs, harq_pid, ndi, rv, tpmi,
                      flag, tpc, vrb_type, n_tx) -> list:
    return [(vrb_type, 1), (_riv(n_rb_dl, rb_start, n_prb), _riv_bits(n_rb_dl)),
            (mcs, 5), (harq_pid, 3), (ndi, 1), (rv, 2), (tpc, 2),
            (tpmi, _tpmi_bits(n_tx)), (flag, 1)]


def _unpack_format1bd(bits, n_rb_dl: int, n_tx: int, flag: str) -> dict:
    r = _Reader(bits)
    vrb_type = r.take(1)
    rb_start, n_prb = _unriv(r.take(_riv_bits(n_rb_dl)), n_rb_dl)
    return {"vrb_type": vrb_type, "rb_start": rb_start, "n_prb": n_prb,
            "mcs": r.take(5), "harq_pid": r.take(3), "ndi": r.take(1),
            "rv": r.take(2), "tpc": r.take(2),
            "tpmi": r.take(_tpmi_bits(n_tx)), flag: r.take(1)}


def pack_dci_format1b(n_rb_dl: int, rb_start: int, n_prb: int, mcs: int,
                      harq_pid: int, ndi: int, rv: int, tpmi: int,
                      pmi_confirm: int, tpc: int = 0, vrb_type: int = 0,
                      n_tx: int = 2) -> np.ndarray:
    fields = _format1bd_fields(n_rb_dl, rb_start, n_prb, mcs, harq_pid, ndi,
                               rv, tpmi, pmi_confirm, tpc, vrb_type, n_tx)
    if n_tx == 2:
        fields.append((0, 1))
    return _pack(fields)


def unpack_dci_format1b(bits: np.ndarray, n_rb_dl: int,
                        n_tx: int = 2) -> dict:
    return _unpack_format1bd(bits, n_rb_dl, n_tx, "pmi_confirm")


def dci_format1d_size(n_rb_dl: int, n_tx: int = 2) -> int:
    return 1 + _riv_bits(n_rb_dl) + 5 + 3 + 1 + 2 + 2 + _tpmi_bits(n_tx) + 1


def pack_dci_format1d(n_rb_dl: int, rb_start: int, n_prb: int, mcs: int,
                      harq_pid: int, ndi: int, rv: int, tpmi: int,
                      dl_power_off: int, tpc: int = 0, vrb_type: int = 0,
                      n_tx: int = 2) -> np.ndarray:
    return _pack(_format1bd_fields(n_rb_dl, rb_start, n_prb, mcs, harq_pid,
                                   ndi, rv, tpmi, dl_power_off, tpc,
                                   vrb_type, n_tx))


def unpack_dci_format1d(bits: np.ndarray, n_rb_dl: int,
                        n_tx: int = 2) -> dict:
    return _unpack_format1bd(bits, n_rb_dl, n_tx, "dl_power_off")
