"""PMCH / MBSFN: the multicast channel over extended-CP subframes, 36.211
§6.5 / §6.10.2 (counterpart of openair4g_tpu/phy/pmch.py).

The MBSFN subframe is one static RE map like the PDSCH's: data on
symbols 2..11 around the port-4 RS comb (spacing 2). The channel estimate
is LS at the comb, a delay-domain LMMSE smoother over the extended CP (a
matmul), and a linear blend in time between the RS symbols.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..device import device_plan
from ..ops.gold import gold_sequence

# MBSFN region: extended-CP symbol indices carrying the port-4 RS and
# their frequency offsets (36.211 Table 6.10.2.2-1, Delta_f = 15 kHz):
# l = 2 of slot 0, l = 0 and l = 4 of slot 1; comb spacing 2.
MBSFN_RS_SYMS = (2, 6, 10)
MBSFN_RS_OFFS = (0, 1, 0)
MBSFN_REGION_START = 2           # symbols 0..1: the (unused) control region


def mbsfn_rs_values(n_id_mbsfn: int, subframe: int, sym: int,
                    n_rb: int) -> np.ndarray:
    """QPSK MBSFN RS r(m) (36.211 §6.10.2.1: c_init = 2^9 (7(ns+1)+l+1)
    (2 Nid+1) + Nid, ns the slot, l the symbol in the slot, ECP)."""
    ns = 2 * subframe + (1 if sym >= 6 else 0)
    l = sym % 6
    cinit = ((1 << 9) * (7 * (ns + 1) + l + 1) * (2 * n_id_mbsfn + 1)
             + n_id_mbsfn)
    n_rb_max = 110
    c = gold_sequence(cinit, 12 * n_rb_max).astype(np.float64)
    m = np.arange(6 * n_rb) + 3 * (n_rb_max - n_rb)
    re = (1 - 2 * c[2 * m]) / np.sqrt(2)
    im = (1 - 2 * c[2 * m + 1]) / np.sqrt(2)
    return (re + 1j * im).astype(np.complex64)


@dataclass(frozen=True, eq=False)
class MbsfnMap:
    fp: FrameParms
    n_data_re: int
    data_sym: np.ndarray
    data_sc: np.ndarray
    data_bin: np.ndarray
    rs_sym: np.ndarray
    rs_sc: np.ndarray
    rs_bin: np.ndarray
    rs_val: np.ndarray


@functools.lru_cache(maxsize=None)
def make_mbsfn_map(n_rb: int, n_id_mbsfn: int = 0,
                   subframe: int = 1) -> MbsfnMap:
    """Static RE map of one MBSFN subframe (extended CP, 12 symbols):
    PMCH data on symbols 2..11 minus the port-4 RS comb."""
    fp = FrameParms(n_rb=n_rb, normal_cp=False, n_id_cell=n_id_mbsfn)
    rs_sym, rs_sc, rs_val = [], [], []
    rs_at = {}
    for sym, off in zip(MBSFN_RS_SYMS, MBSFN_RS_OFFS):
        scs = np.arange(off, fp.n_sc, 2, dtype=np.int32)
        rs_at[sym] = set(scs.tolist())
        rs_sym.append(np.full(len(scs), sym, np.int32))
        rs_sc.append(scs)
        rs_val.append(mbsfn_rs_values(n_id_mbsfn, subframe, sym, n_rb))
    rs_sym = np.concatenate(rs_sym)
    rs_sc = np.concatenate(rs_sc)
    data_sym, data_sc = [], []
    for sym in range(MBSFN_REGION_START, fp.symbols_per_subframe):
        skip = rs_at.get(sym, set())
        for k in range(fp.n_sc):
            if k not in skip:
                data_sym.append(sym)
                data_sc.append(k)
    data_sym = np.asarray(data_sym, np.int32)
    data_sc = np.asarray(data_sc, np.int32)
    return MbsfnMap(fp=fp, n_data_re=len(data_sym), data_sym=data_sym,
                    data_sc=data_sc, data_bin=fp.sc_to_bin(data_sc),
                    rs_sym=rs_sym, rs_sc=rs_sc, rs_bin=fp.sc_to_bin(rs_sc),
                    rs_val=np.concatenate(rs_val))


def pmch_cinit(n_id_mbsfn: int, subframe: int) -> int:
    """PMCH scrambling c_init (36.211 §6.3.1, PMCH case):
    c_init = (ns/2) 2^9 + N_ID^MBSFN."""
    return (subframe << 9) + n_id_mbsfn


@functools.lru_cache(maxsize=None)
def _plan(mm: MbsfnMap, device) -> dict:
    """The map's static plans on `device`, uploaded once: the grid fill
    (source indices into concat([data, RS, zero])), the RS positions and
    conjugated values per RS symbol [3, 6 n_rb], and per data RE the RS
    symbol pair (seg, seg + 1) it lies between, its linear weight t toward
    seg + 1, and its comb sample k // 2 (the smoother reconstructs the
    band at CP resolution from the comb)."""
    fp = mm.fp
    nd, nr = mm.n_data_re, len(mm.rs_sym)
    fill = np.full(fp.symbols_per_subframe * fp.n_fft, nd + nr, np.int64)
    fill[mm.data_sym.astype(np.int64) * fp.n_fft + mm.data_bin] = \
        np.arange(nd)
    fill[mm.rs_sym.astype(np.int64) * fp.n_fft + mm.rs_bin] = \
        nd + np.arange(nr)
    n_per = 6 * fp.n_rb
    sym_f = np.asarray(MBSFN_RS_SYMS, np.float64)
    seg = np.zeros(fp.symbols_per_subframe, np.int64)
    t01 = np.zeros(fp.symbols_per_subframe, np.float32)
    for sym in range(MBSFN_REGION_START, fp.symbols_per_subframe):
        k = int(np.clip(np.searchsorted(sym_f, sym) - 1, 0, 1))
        seg[sym] = k
        t01[sym] = np.clip((sym - sym_f[k]) / (sym_f[k + 1] - sym_f[k]),
                           0.0, 1.0)
    plan = {"fill": fill, "rs_val": mm.rs_val,
            "rs_sym": np.asarray(MBSFN_RS_SYMS, np.int64)[:, None],
            "rs_bin": mm.rs_bin.reshape(len(MBSFN_RS_SYMS), -1).astype(
                np.int64),
            "rs_ref": np.conj(mm.rs_val).reshape(len(MBSFN_RS_SYMS), -1),
            "seg": seg[mm.data_sym],
            "comb": np.clip(mm.data_sc // 2, 0, n_per - 1).astype(np.int64),
            "t": t01[mm.data_sym], "one_minus_t": (1 - t01)[mm.data_sym]}
    return {k: torch.as_tensor(v, device=device) for k, v in plan.items()}


def mbsfn_fill_grid(symbols, mm: MbsfnMap):
    """symbols [B, n_data_re] -> grid [B, 12, n_fft] complex64 with the
    MBSFN RS in place (one gather)."""
    B = symbols.shape[0]
    fp = mm.fp
    p = _plan(mm, symbols.device)
    src = torch.cat([symbols.to(torch.complex64),
                     p["rs_val"].expand(B, -1),
                     symbols.new_zeros(B, 1, dtype=torch.complex64)], dim=1)
    return src[:, p["fill"]].reshape(B, fp.symbols_per_subframe, fp.n_fft)


@functools.lru_cache(maxsize=None)
def _mbsfn_wiener(n_rb: int, n0: float) -> np.ndarray:
    """Delay-domain LMMSE smoother for the spacing-2 RS comb, in double:
    prior uniform over the extended CP (the MBSFN composite channel is that
    long). Returned as the complex64 W^T the estimate multiplies by."""
    fp = FrameParms(n_rb=n_rb, normal_cp=False)
    m = 6 * n_rb
    f_idx = 2 * np.arange(m) - 6 * n_rb      # comb at spacing 2
    L = fp.cp
    taps = np.arange(L)
    F = np.exp(-2j * np.pi * f_idx[:, None] * taps[None, :] / fp.n_fft)
    P = 1.0 / L
    A = (F * P) @ F.conj().T + n0 * np.eye(m)
    W = (F * P) @ F.conj().T @ np.linalg.inv(A)
    return W.T.astype(np.complex64)


def mbsfn_estimate_channel(rgrid, mm: MbsfnMap, n0: float):
    """LS at the RS comb -> smooth -> interpolate to all data REs:
    rgrid [B, 12, n_fft] -> H_hat [B, n_data_re]."""
    p = _plan(mm, rgrid.device)
    W = device_plan(_mbsfn_wiener(mm.fp.n_rb, float(n0)), rgrid.device)
    ls = rgrid[:, p["rs_sym"], p["rs_bin"]] * p["rs_ref"]    # [B, 3, n_per]
    h_rs = torch.matmul(ls, W)                               # [B, 3, n_per]
    seg, comb = p["seg"], p["comb"]
    return p["one_minus_t"] * h_rs[:, seg, comb] \
        + p["t"] * h_rs[:, seg + 1, comb]
