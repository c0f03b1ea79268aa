"""UCI on PUSCH: CQI/RI/ACK coding, dimensioning and channel multiplexing,
3GPP TS 36.212 §5.2.2.6-5.2.2.8 (counterpart of openair4g_tpu/ops/uci.py).

The channel interleaver is resolved once on the host into static index
maps over the modulation symbols of the [C, M] PUSCH data grid (flat
index p = sym * M + subcarrier); TX is scatters of complex symbols, RX
gathers of LLRs, and the ACK puncturing of data a static zero mask.
RI/ACK symbols are drawn from the maximum-distance corner subset (the
effect of the spec's x/y placeholder bits) and bypass scrambling.

CQI coding: O <= 11 payload bits use the (32, O) Reed-Muller code of
36.212 Table 5.2.2.6.4-1 with circular repetition, decoded ML by one
matmul against the whole codebook; O >= 12 uses CRC8, the rate-1/3
tail-biting convolutional code and CC rate matching, decoded by the
circular Viterbi of ops/convcode.py.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..device import device_plan
from ..tables.modulation import mod_table
from .convcode import conv_encode_device, viterbi_decode
from .crc import crc_device, crc_matrix, crc_remainder
from .rate_match import (cc_rate_match_rx, cc_rate_match_tx,
                         make_cc_rate_match_maps)

# 36.212 Table 5.2.2.6.4-1: basis sequences M_{i,n} of the (32, O<=11) code.
RM32_BASIS = np.array([
    [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1],
    [1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1],
    [1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1],
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1],
    [1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1],
    [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1],
    [1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1],
    [1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1],
    [1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1],
    [1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1],
    [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1],
    [1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1],
    [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0],
    [1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0],
    [1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0],
    [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0],
    [1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1],
    [1, 1, 0, 1, 0, 0, 0, 0, 0, 1, 1],
    [1, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1],
    [1, 1, 1, 0, 1, 0, 0, 0, 1, 1, 1],
    [1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 0],
    [1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1],
    [1, 0, 1, 1, 0, 1, 0, 0, 1, 1, 0],
    [1, 1, 1, 1, 0, 1, 0, 1, 1, 1, 0],
    [1, 0, 1, 0, 1, 1, 1, 0, 1, 0, 0],
    [1, 0, 1, 1, 1, 1, 1, 1, 1, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
], np.int8)

# Column sets of the channel interleaver (36.212 Tables 5.2.2.8-1/2),
# normal / extended CP; the visit order cycles {c0, c3, c2, c1}.
CS_RI = {True: (1, 4, 7, 10), False: (0, 3, 5, 8)}
CS_ACK = {True: (2, 3, 8, 9), False: (1, 2, 6, 7)}


# ----------------------------------------------------------- dimensioning --

@dataclass(frozen=True)
class UciConfig:
    """UCI payload riding on one PUSCH (36.213 beta offsets as linear)."""
    o_cqi: int = 0          # CQI/PMI payload bits
    o_ri: int = 0           # 0 or 1
    o_ack: int = 0          # 0, 1 or 2
    beta_cqi: float = 2.0
    beta_ri: float = 2.0
    beta_ack: float = 2.0

    @property
    def any(self) -> bool:
        return (self.o_cqi + self.o_ri + self.o_ack) > 0


@dataclass(frozen=True)
class UciMaps:
    """Static multiplexing plan for one (PUSCH allocation, MCS, UCI) tuple.
    The *_pos arrays are flat modulation-symbol indices into the [C, M]
    data grid (p = sym * M + subcarrier row)."""
    Qm: int
    C: int                   # SC-FDMA data symbols (Cmux)
    M: int                   # subcarriers (Rmux')
    qp_cqi: int              # CQI modulation symbols
    qp_ri: int
    qp_ack: int
    G_data: int              # UL-SCH coded bits after the CQI/RI reservation
    Q_cqi: int               # CQI coded bits
    cqi_pos: np.ndarray      # [qp_cqi]
    data_pos: np.ndarray     # [G_data // Qm]
    ri_pos: np.ndarray       # [qp_ri]
    ack_pos: np.ndarray      # [qp_ack]
    data_keep: np.ndarray    # bool [G_data]: False where ACK punctures


def _q_prime(O: int, msc: int, nsymb: int, beta: float,
             sum_kr: int) -> int:
    """Q' = min(ceil(O Msc Nsymb beta / sum Kr), 4 Msc) (36.212 §5.2.2.6)."""
    if O == 0:
        return 0
    q = -(-(O * msc * nsymb * int(round(beta * 1000))) // (1000 * sum_kr))
    return min(q, 4 * msc)


def _mat_to_grid(r: np.ndarray, c: np.ndarray, C: int, M: int) -> np.ndarray:
    """(row, col) of the interleaver matrix -> flat [C, M] grid symbol."""
    return (c * M + r).astype(np.int32)


@functools.lru_cache(maxsize=None)
def make_uci_maps(m_sc: int, n_data_sym: int, Qm: int, sum_kr: int,
                  o_cqi: int, o_ri: int, o_ack: int,
                  beta_cqi: float, beta_ri: float, beta_ack: float,
                  normal_cp: bool = True) -> UciMaps:
    """Resolve 36.212 §5.2.2.7/5.2.2.8 into static index maps."""
    C, M = n_data_sym, m_sc
    H_sym = C * M                                      # total symbols

    qp_ri = _q_prime(o_ri, m_sc, n_data_sym, beta_ri, sum_kr)
    qp_ack = _q_prime(o_ack, m_sc, n_data_sym, beta_ack, sum_kr)
    L = 8 if o_cqi >= 12 else 0
    qp_cqi = _q_prime(o_cqi + L, m_sc, n_data_sym, beta_cqi, sum_kr) \
        if o_cqi else 0
    # keep at least one symbol of data
    qp_cqi = min(qp_cqi, H_sym - qp_ri - 1) if o_cqi else 0

    n_data_syms = H_sym - qp_ri - qp_cqi
    G_data = n_data_syms * Qm
    Q_cqi = qp_cqi * Qm

    # RI positions: bottom-up rows, columns cycling {c0,c3,c2,c1}
    cs_ri = CS_RI[normal_cp]
    j_order = (0, 3, 2, 1)
    i = np.arange(qp_ri)
    ri_r = M - 1 - (i >> 2)
    ri_c = np.asarray([cs_ri[j_order[k & 3]] for k in i], np.int64) \
        if qp_ri else np.zeros(0, np.int64)
    ri_pos = _mat_to_grid(ri_r, ri_c, C, M) if qp_ri else \
        np.zeros(0, np.int32)

    # CQI then data fill the matrix row-major, skipping RI holes
    occupied = np.zeros((M, C), bool)
    if qp_ri:
        occupied[ri_r, ri_c] = True
    free_rm = np.nonzero(~occupied.reshape(-1))[0]     # row-major flat r*C+c
    assert len(free_rm) == n_data_syms + qp_cqi
    fr, fc = free_rm // C, free_rm % C
    free_grid = _mat_to_grid(fr, fc, C, M)
    cqi_pos = free_grid[:qp_cqi]
    data_pos = free_grid[qp_cqi:]

    # ACK overwrites (punctures) whatever sits at its positions
    i = np.arange(qp_ack)
    cs_ack = CS_ACK[normal_cp]
    ack_r = M - 1 - (i >> 2)
    ack_c = np.asarray([cs_ack[j_order[k & 3]] for k in i], np.int64) \
        if qp_ack else np.zeros(0, np.int64)
    ack_pos = _mat_to_grid(ack_r, ack_c, C, M) if qp_ack else \
        np.zeros(0, np.int32)

    punched = np.isin(data_pos, ack_pos)
    data_keep = np.repeat(~punched, Qm)
    return UciMaps(Qm=Qm, C=C, M=M, qp_cqi=qp_cqi, qp_ri=qp_ri,
                   qp_ack=qp_ack, G_data=G_data, Q_cqi=Q_cqi,
                   cqi_pos=cqi_pos.astype(np.int32),
                   data_pos=data_pos.astype(np.int32),
                   ri_pos=ri_pos, ack_pos=ack_pos, data_keep=data_keep)


# ------------------------------------------------------------- CQI coding --

@functools.lru_cache(maxsize=None)
def _rm32_basis(O: int) -> np.ndarray:
    """[O, 32] float32: the generator rows of the (32, O) code."""
    return RM32_BASIS[:, :O].T.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rm32_codebook(O: int) -> np.ndarray:
    """[2^O, 32] all codewords of the (32, O) code (for the ML decode)."""
    if not 1 <= O <= 11:
        raise ValueError(f"O={O}: the (32, O) code takes 1..11 bits")
    msgs = ((np.arange(1 << O)[:, None] >> np.arange(O)) & 1).astype(np.int8)
    return (msgs @ RM32_BASIS[:, :O].T) % 2


def _codebook_signs_t(cb: np.ndarray) -> np.ndarray:
    return (1.0 - 2.0 * cb).T.astype(np.float32)


def cqi_encode_device(bits, Q_cqi: int):
    """Batched CQI encode. bits [B, O] {0,1} -> coded [B, Q_cqi] int32."""
    B, O = bits.shape
    dev = bits.device
    if O <= 11:
        basis = device_plan(_rm32_basis(O), dev)
        code = torch.remainder(bits.to(torch.float32) @ basis, 2.0)
        code = code.to(torch.int32)                             # [B, 32]
        reps = -(-Q_cqi // 32)
        return code.repeat(1, reps)[:, :Q_cqi]
    crc = torch.round(crc_device(bits, "crc8")).to(torch.int32)
    with_crc = torch.cat([bits.to(torch.int32), crc], dim=1)
    d = conv_encode_device(with_crc).reshape(B, -1)            # [B, 3*(O+8)]
    maps = make_cc_rate_match_maps(O + 8, Q_cqi)
    return cc_rate_match_tx(d, maps).to(torch.int32)


def cqi_decode(llr, O: int):
    """Coded-bit LLRs [B, Q_cqi] -> (bits [B, O], ok [B]). O <= 11: ML
    correlation against the whole codebook, the first maximum on a tie;
    O >= 12: CC rate de-matching, the tail-biting Viterbi, the CRC8
    check."""
    B, Q = llr.shape
    dev = llr.device
    if O <= 11:
        reps = -(-Q // 32)
        pad = torch.zeros(B, reps * 32 - Q, dtype=llr.dtype, device=dev)
        folded = torch.cat([llr, pad], dim=1).reshape(B, reps, 32).sum(dim=1)
        scores = folded @ device_plan(_rm32_codebook(O), dev,
                                      _codebook_signs_t)
        best = torch.argmax(scores, dim=-1)
        bits = (best[:, None] >> torch.arange(O, device=dev)) & 1
        return bits.to(torch.int32), torch.ones(B, dtype=torch.bool,
                                                device=dev)
    maps = make_cc_rate_match_maps(O + 8, Q)
    bits = viterbi_decode(cc_rate_match_rx(llr, maps), O + 8)   # [B, O+8]
    rem = crc_remainder(bits, crc_matrix(O + 8, "crc8"))
    return bits[:, :O], torch.all(rem < 0.5, dim=-1)


# ------------------------------------------------ RI/ACK symbol-level code --

@functools.lru_cache(maxsize=None)
def _mod_table(Qm: int) -> np.ndarray:
    return mod_table(Qm)


def _corner_symbol(Qm: int, b0, b1):
    """Constellation point of the bits [b0, b1, 1, 1, ...]: the
    maximum-energy corner that the spec's x-placeholder rule selects."""
    idx_base = int(np.sum(1 << np.arange(Qm - 3, -1, -1))) if Qm > 2 else 0
    idx = b0 * (1 << (Qm - 1)) + b1 * (1 << (Qm - 2)) + idx_base
    return device_plan(_mod_table(Qm), b0.device)[idx.long()]


def uci1_symbols(o, Qm: int, qp: int):
    """1-bit RI/ACK o [B] -> [B, qp] modulation symbols ([o, y = o, x ...]
    repeated)."""
    s = _corner_symbol(Qm, o, o)
    return s[:, None].expand(s.shape[0], qp)


def uci2_symbols(o, Qm: int, qp: int):
    """2-bit ACK o [B, 2] -> [B, qp] symbols: the triplet (o0, o1),
    (o2, o0), (o1, o2) with o2 = o0 ^ o1, cycled."""
    o0, o1 = o[:, 0], o[:, 1]
    o2 = torch.bitwise_xor(o0, o1)
    trip = torch.stack([_corner_symbol(Qm, o0, o1),
                        _corner_symbol(Qm, o2, o0),
                        _corner_symbol(Qm, o1, o2)], dim=1)    # [B, 3]
    return trip[:, device_plan(_cycle3(qp), o.device, dtype=torch.long)]


@functools.lru_cache(maxsize=None)
def _cycle3(qp: int) -> np.ndarray:
    return np.arange(qp) % 3


def uci1_decode(sym_llr2):
    """Per-symbol (b0, b1) LLRs [B, qp, 2] -> bit [B] (0/1) of a 1-bit UCI:
    1 where the summed LLR is strictly negative."""
    m = sym_llr2.sum(dim=(1, 2))
    return (m < 0).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _uci2_hypotheses(qp: int) -> np.ndarray:
    """[qp * 2, 4] signs of each 2-bit hypothesis (h = o0 + 2 o1): symbol
    k carries bits pattern[k % 3] of (o0, o1, o2)."""
    pat = np.array([[0, 1], [2, 0], [1, 2]])
    hyp = []
    for h in range(4):
        o = np.array([h & 1, (h >> 1) & 1])
        o = np.append(o, o[0] ^ o[1])
        hyp.append((1.0 - 2.0 * o[pat[np.arange(qp) % 3]]).reshape(-1))
    return np.stack(hyp, axis=1).astype(np.float32)


def uci2_decode(sym_llr2):
    """[B, qp, 2] -> 2-bit ACK [B, 2] by ML over the 4 hypotheses, the
    first maximum on a tie."""
    B, qp, _ = sym_llr2.shape
    scores = sym_llr2.reshape(B, -1) @ device_plan(_uci2_hypotheses(qp),
                                                   sym_llr2.device)
    best = torch.argmax(scores, dim=-1)
    return torch.stack([best & 1, (best >> 1) & 1], dim=-1).to(torch.int32)


# ------------------------------------------------------------ multiplexing --

def _pos(a: np.ndarray, dev):
    return device_plan(a, dev, dtype=torch.long)


def _keep(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32)


def uci_multiplex(data_sym, cqi_sym, ri_sym, ack_sym, maps: UciMaps):
    """Scatter modulation symbols into the [B, C, M] PUSCH data grid:
    data_sym [B, G_data / Qm], cqi_sym [B, qp_cqi] (or None), ri/ack_sym
    [B, qp] (or None). The data_pos order holds the row-major write and
    column read of the interleaver."""
    B, dev = data_sym.shape[0], data_sym.device
    y = torch.zeros(B, maps.C * maps.M, dtype=torch.complex64, device=dev)
    y[:, _pos(maps.data_pos, dev)] = data_sym
    if maps.qp_cqi:
        y[:, _pos(maps.cqi_pos, dev)] = cqi_sym
    if maps.qp_ri:
        y[:, _pos(maps.ri_pos, dev)] = ri_sym
    if maps.qp_ack:
        y[:, _pos(maps.ack_pos, dev)] = ack_sym
    return y.reshape(B, maps.C, maps.M)


def uci_demultiplex(llr_grid, maps: UciMaps):
    """llr_grid [B, C, M, Qm] per-symbol LLRs -> the streams: data
    [B, G_data] (ACK-punctured positions zeroed), cqi [B, Q_cqi], ri and
    ack [B, qp, 2] (the first two bits of each UCI symbol)."""
    B, dev = llr_grid.shape[0], llr_grid.device
    flat = llr_grid.reshape(B, maps.C * maps.M, maps.Qm)
    data = flat[:, _pos(maps.data_pos, dev)].reshape(B, -1)
    out = {"data": data * device_plan(maps.data_keep, dev, _keep)}
    if maps.qp_cqi:
        out["cqi"] = flat[:, _pos(maps.cqi_pos, dev)].reshape(B, -1)
    if maps.qp_ri:
        out["ri"] = flat[:, _pos(maps.ri_pos, dev)][..., :2]
    if maps.qp_ack:
        out["ack"] = flat[:, _pos(maps.ack_pos, dev)][..., :2]
    return out
