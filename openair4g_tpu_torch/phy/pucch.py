"""PUCCH formats 1/1a/1b (SR and HARQ ACK/NACK), 2 (CQI) and 2a/2b (CQI
with 1 or 2 ACK bits), 36.211 §5.4, and the (20, A) block code of 36.212
§5.2.3.3 (counterpart of openair4g_tpu/phy/pucch.py).

One PUCCH transmission is a [n_sym, 12] tensor: the covers, cyclic
shifts and reference symbols are numpy constants built once, and
detection is a batched conjugate correlation. Format-2 ML decoding
correlates the LLRs with all 2^A codewords in one [B, 20] x [20, 2^A]
matmul; its decision is the first maximum on a tie.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import device_plan
from ..ops.gold import gold_sequence
from .ulref import zc_base_sequence

# length-4 orthogonal covers for data symbols (36.211 Table 5.4.1-2)
_W4 = np.array([[1, 1, 1, 1],
                [1, -1, 1, -1],
                [1, -1, -1, 1]], np.float64)
# length-3 DFT covers for RS symbols (Table 5.5.2.2.1-2)
_W3 = np.exp(2j * np.pi / 3 * np.array([[0, 0, 0],
                                        [0, 1, 2],
                                        [0, 2, 1]], np.float64))

DATA_SYMS_F1 = (0, 1, 5, 6)    # within a slot, normal CP
RS_SYMS_F1 = (2, 3, 4)
DATA_SYMS_F2 = (0, 2, 3, 4, 6)
RS_SYMS_F2 = (1, 5)


@functools.lru_cache(maxsize=None)
def ncs_cell(nid_cell: int, normal_cp: bool = True) -> np.ndarray:
    """[20 slots, 7 syms] cell cyclic-shift hopping n_cs_cell(ns, l)
    (36.211 §5.4)."""
    nsym = 7 if normal_cp else 6
    c = gold_sequence(nid_cell, 8 * nsym * 20)
    out = np.zeros((20, nsym), np.int32)
    for ns in range(20):
        for l in range(nsym):
            v = 0
            for i in range(8):
                v += int(c[8 * nsym * ns + 8 * l + i]) << i
            out[ns, l] = v
    return out


def _alpha_seq(nid_cell: int, ns: int, l: int, n_cs1: int) -> np.ndarray:
    """Cyclically shifted base sequence r_alpha(n) for slot ns, symbol l."""
    ncs = (int(ncs_cell(nid_cell)[ns, l]) + n_cs1) % 12
    alpha = 2.0 * np.pi * ncs / 12.0
    r = zc_base_sequence(0, 0, 12)
    return (np.exp(1j * alpha * np.arange(12)) * r).astype(np.complex64)


def pucch1_slot_symbols(nid_cell: int, ns: int, n_cs1: int, n_oc: int,
                        d: complex) -> tuple:
    """One slot of format 1/1a/1b: (data [4, 12], rs [3, 12]) complex64;
    d = 1 (format 1, SR), BPSK +-1 (1a), QPSK (1b)."""
    data = np.stack([
        d * _W4[n_oc, i] * _alpha_seq(nid_cell, ns, l, n_cs1)
        for i, l in enumerate(DATA_SYMS_F1)])
    rs = np.stack([
        _W3[n_oc, i] * _alpha_seq(nid_cell, ns, l, n_cs1)
        for i, l in enumerate(RS_SYMS_F1)])
    return data.astype(np.complex64), rs.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _f1_refs(nid_cell: int, ns: int, n_cs1: int, n_oc: int) -> tuple:
    """The conjugate format-1 references (data, rs) of one slot."""
    data, rs = pucch1_slot_symbols(nid_cell, ns, n_cs1, n_oc, 1.0)
    return np.conj(data), np.conj(rs)


def pucch1_detect(rx_data, rx_rs, nid_cell: int, ns: int, n_cs1: int,
                  n_oc: int):
    """Coherent format-1 detection of one slot. rx_data [B, 4, 12], rx_rs
    [B, 3, 12] -> (z [B] complex decision variable, rs_energy [B]): d_hat
    is z; ACK/NACK is sign(Re z) (1a) or the quadrant (1b)."""
    data_c, rs_c = _f1_refs(nid_cell, ns, n_cs1, n_oc)
    dev = rx_data.device
    h = torch.sum(rx_rs * device_plan(rs_c, dev), dim=(-1, -2))      # [B]
    z = torch.sum(rx_data * device_plan(data_c, dev), dim=(-1, -2))
    # normalize by the RS channel estimate (coherent demodulation)
    return z * torch.conj(h), h.abs() ** 2


# ---------------------------------------------------------------------------
# Format 2: (20, A) block code, 36.212 Table 5.2.3.3-1
# ---------------------------------------------------------------------------

# basis sequences M_{i,n}, i = 0..19, n = 0..12
RM20_BASIS = np.array([
    [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0],
    [1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1],
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 1, 1],
    [1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1],
    [1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 1],
    [1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1, 1, 1],
    [1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1],
    [1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 0, 1],
    [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0, 1, 1],
    [1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0]], np.int8)


def rm20_encode(a_bits: np.ndarray) -> np.ndarray:
    """a [A <= 13] -> 20 coded bits."""
    A = len(a_bits)
    return (RM20_BASIS[:, :A] @ np.asarray(a_bits, np.int64)) % 2


@functools.lru_cache(maxsize=None)
def _rm20_codebook(A: int) -> np.ndarray:
    """[2^A, 20] all codewords (for ML decoding)."""
    msgs = ((np.arange(1 << A)[:, None] >> np.arange(A)) & 1).astype(np.int64)
    return (msgs @ RM20_BASIS[:, :A].T.astype(np.int64)) % 2


def _signs_t(cb: np.ndarray) -> np.ndarray:
    return (1.0 - 2.0 * cb).astype(np.float32).T


def rm20_decode(llr20, A: int):
    """ML decode. llr20 [B, 20] (positive <=> bit 0) -> bits [B, A]."""
    dev = llr20.device
    scores = llr20 @ device_plan(_rm20_codebook(A), dev, _signs_t)  # [B, 2^A]
    best = torch.argmax(scores, dim=-1)
    return (best[:, None] >> torch.arange(A, device=dev)) & 1


def pucch2_slot_symbols(nid_cell: int, ns: int, n_cs1: int,
                        d5: np.ndarray) -> tuple:
    """One slot of format 2: 5 QPSK payload symbols d5 [5] on the shifted
    base sequence; RS on symbols 1 and 5."""
    data = np.stack([
        d5[i] * _alpha_seq(nid_cell, ns, l, n_cs1)
        for i, l in enumerate(DATA_SYMS_F2)])
    rs = np.stack([
        _alpha_seq(nid_cell, ns, l, n_cs1)
        for l in RS_SYMS_F2])
    return data.astype(np.complex64), rs.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _f2_refs(nid_cell: int, ns: int, n_cs1: int) -> tuple:
    """The conjugate format-2 references (data sequences [5, 12], rs
    [2, 12]) of one slot."""
    _, rs = pucch2_slot_symbols(nid_cell, ns, n_cs1, np.ones(5))
    seqs = np.stack([_alpha_seq(nid_cell, ns, l, n_cs1)
                     for l in DATA_SYMS_F2])
    return np.conj(seqs), np.conj(rs)


def pucch2_equalize(rx_data, rx_rs, nid_cell: int, ns: int, n_cs1: int):
    """rx_data [B, 5, 12], rx_rs [B, 2, 12] -> (d_hat [B, 5] coherent,
    channel power [B])."""
    seqs_c, rs_c = _f2_refs(nid_cell, ns, n_cs1)
    dev = rx_data.device
    h = torch.sum(rx_rs * device_plan(rs_c, dev), dim=(-1, -2))     # [B]
    z = torch.sum(rx_data * device_plan(seqs_c, dev), dim=-1)      # [B, 5]
    return z * torch.conj(h)[:, None], h.abs() ** 2


# ----------------------------------------------------------- formats 2a/2b
# Mixed CQI + ACK (36.211 §5.4.2 Table 5.4.2-1): the 1-2 HARQ-ACK bits
# modulate the second RS symbol of each slot (normal CP: symbol 5) as
# BPSK (2a) or QPSK (2b); the 20 CQI bits ride the 5 data symbols as in
# format 2.

def pucch2x_ack_symbol(ack_bits) -> complex:
    """36.211 Table 5.4.2-1: 1 bit -> BPSK {0: +1, 1: -1}; 2 bits -> QPSK
    {00: +1, 01: -j, 10: +j, 11: -1}."""
    b = tuple(int(x) for x in np.atleast_1d(ack_bits))
    if len(b) == 1:
        return 1.0 + 0j if b[0] == 0 else -1.0 + 0j
    return {(0, 0): 1 + 0j, (0, 1): -1j, (1, 0): 1j, (1, 1): -1 + 0j}[b]


def pucch2x_slot_symbols(nid_cell: int, ns: int, n_cs1: int,
                         d5: np.ndarray, d_ack: complex) -> tuple:
    """Format 2a/2b slot: format 2 with d_ack on the second RS symbol.
    Returns (data [5, 12], rs [2, 12])."""
    data, rs = pucch2_slot_symbols(nid_cell, ns, n_cs1, d5)
    rs = rs.copy()
    rs[1] = rs[1] * np.complex64(d_ack)
    return data, rs


_ACK_POINTS = np.asarray([1 + 0j, -1j, 1j, -1 + 0j], np.complex64)


def pucch2x_detect(rx_data, rx_rs, nid_cell: int, ns: int, n_cs1: int,
                   n_ack: int):
    """Joint CQI and ACK reception of one slot. rx_data [B, 5, 12], rx_rs
    [B, 2, 12]. The channel comes from the first (ACK-free) RS symbol, the
    ACK symbol is detected coherently against it, and the CQI symbols are
    equalized with both RS symbols once the detected ACK modulation is
    wiped. Returns (z5 [B, 5] equalized CQI symbols, h2 [B] channel power,
    ack_bits [B, n_ack])."""
    seqs_c, rs_c = _f2_refs(nid_cell, ns, n_cs1)
    dev = rx_data.device
    rs_t = device_plan(rs_c, dev)
    h1 = torch.sum(rx_rs[:, 0] * rs_t[0], dim=-1)
    z_ack = torch.sum(rx_rs[:, 1] * rs_t[1], dim=-1)
    rho = z_ack * torch.conj(h1)                     # ~ |h|^2 d_ack
    if n_ack == 1:
        ack = (rho.real < 0).to(torch.int32)[:, None]
        d_hat = 1.0 - 2.0 * ack[:, 0].to(torch.float32)
    else:
        # ML slicing on {1, -j, +j, -1}: which of |Re|, |Im| dominates,
        # and its sign
        re, im = rho.real, rho.imag
        im_wins, re_wins = im.abs() > re.abs(), re.abs() > im.abs()
        ack0 = ((im > 0) & im_wins) | ((re < 0) & re_wins)
        ack1 = ((im < 0) & im_wins) | ((re < 0) & re_wins)
        ack = torch.stack([ack0, ack1], dim=-1).to(torch.int32)
        d_hat = device_plan(_ACK_POINTS, dev)[(ack[:, 0] * 2
                                               + ack[:, 1]).long()]
    # wipe the ACK modulation off the second RS and combine both RS symbols
    h = 0.5 * (h1 + z_ack * torch.conj(d_hat))
    z = torch.sum(rx_data * device_plan(seqs_c, dev), dim=-1)   # [B, 5]
    return z * torch.conj(h)[:, None], h.abs() ** 2, ack
