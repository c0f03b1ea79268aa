"""Control-region REG/CCE resource mapping (36.211 §6.7/§6.8.5).

Reference parity: openair1/PHY/LTE_TRANSPORT/pcfich.c (4 REGs in symbol 0 at
the cell-ID-derived quadruplet positions), phich.c (REG allocation), dci.c
(PDCCH REG interleaving: sub-block column permutation + cell-ID cyclic
shift).

All mappings are config-time numpy index arrays; on device the control
region is one gather/scatter, like the PDSCH grid maps.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..config import FrameParms
from ..ops.rate_match import PERM32


@dataclass(frozen=True)
class ControlRegionMap:
    fp: FrameParms
    n_pdcch: int
    n_cce: int
    # PCFICH: 16 REs (4 REGs x 4)
    pcfich_sym: np.ndarray
    pcfich_sc: np.ndarray
    pcfich_bin: np.ndarray
    # PDCCH: n_cce*36 REs in CCE order
    pdcch_sym: np.ndarray
    pdcch_sc: np.ndarray
    pdcch_bin: np.ndarray


def _regs_in_symbol(fp: FrameParms, sym: int, nports: int = 2) -> np.ndarray:
    """REG subcarrier-start table for one control symbol.

    Returns [n_reg, 4] occupied-grid subcarrier indices. Symbol 0 (and
    symbol 1 when nports == 4) carries RS every 3 subcarriers: each RB
    yields 2 REGs of the 8 non-RS REs. Other symbols: 3 REGs of 4.
    """
    has_rs = (sym == 0) or (sym == 1 and nports == 4)
    regs = []
    rs_mod3 = fp.n_id_cell % 3
    for rb in range(fp.n_rb):
        base = 12 * rb
        if has_rs:
            res = [base + k for k in range(12) if (k % 3) != rs_mod3]
            regs.append(res[:4])
            regs.append(res[4:])
        else:
            for j in range(3):
                regs.append([base + 4 * j + k for k in range(4)])
    return np.asarray(regs, np.int32)


def _pcfich_reg_indices(fp: FrameParms) -> np.ndarray:
    """Indices (into the symbol-0 REG list) of the 4 PCFICH REGs
    (36.211 §6.7.4): k̄ = (Nsc/2)(Nid mod 2N_RB), quadruplets spaced
    ⌊N_RB/2⌋·Nsc/2 subcarriers; REGs here are 2 per RB => REG index =
    subcarrier/6."""
    k_bar = 6 * (fp.n_id_cell % (2 * fp.n_rb))
    idx = []
    for j in range(4):
        k = (k_bar + (j * fp.n_rb // 2) * 6) % fp.n_sc
        idx.append(k // 6)
    return np.asarray(idx, np.int32)


def phich_reg_indices(fp: FrameParms, n_group: int = 1) -> list:
    """Symbol-0 REG-list indices used by n_group PHICH groups, avoiding the
    PCFICH REGs (36.211 §6.9.3 spread pattern: n_bar_i offsets of
    floor(n_reg/3))."""
    regs = _regs_in_symbol(fp, 0)
    taken = set(int(i) for i in _pcfich_reg_indices(fp))
    avail = [i for i in range(len(regs)) if i not in taken]
    n_avail = len(avail)
    out = []
    for g in range(n_group):
        idx = []
        for i in range(3):
            k = (fp.n_id_cell + g + i * (n_avail // 3)) % n_avail
            while avail[k] in taken:
                k = (k + 1) % n_avail
            taken.add(avail[k])
            idx.append(avail[k])
        out.append(idx)
    return out


@functools.lru_cache(maxsize=None)
def make_control_region_map(n_rb: int, n_pdcch: int, n_id_cell: int = 0,
                            nports: int = 2, normal_cp: bool = True,
                            n_phich_groups: int = 0) -> ControlRegionMap:
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp, n_id_cell=n_id_cell)
    # collect all REGs as (sym, [4 sc]) in symbol-major order
    reg_sym, reg_sc = [], []
    pcfich_regs = set()
    sym0 = _regs_in_symbol(fp, 0, nports)
    for i in _pcfich_reg_indices(fp):
        pcfich_regs.add(int(i))
    # PHICH REGs (if any) are not available to the PDCCH either
    sym0_taken = set(pcfich_regs)
    for g in phich_reg_indices(fp, n_phich_groups):
        sym0_taken |= set(g)

    pcfich_sym, pcfich_sc = [], []
    for i in sorted(pcfich_regs):
        pcfich_sym += [0] * 4
        pcfich_sc += list(sym0[i])

    for sym in range(n_pdcch):
        regs = _regs_in_symbol(fp, sym, nports) if sym else sym0
        for i, quad in enumerate(regs):
            if sym == 0 and i in sym0_taken:
                continue
            reg_sym.append(sym)
            reg_sc.append(quad)
    n_reg = len(reg_sym)
    n_cce = n_reg // 9

    # 36.211 §6.8.5: REG quadruplet sub-block interleaving (32 columns,
    # PERM32) then cyclic shift by N_id_cell
    R = -(-n_reg // 32)
    kpi = 32 * R
    nd = kpi - n_reg
    order = []
    for k in range(kpi):
        c, r = k // R, k % R
        pos = r * 32 + PERM32[c]
        if pos >= nd:
            order.append(pos - nd)
    order = np.asarray(order, np.int64)
    order = np.roll(order, -(n_id_cell % n_reg))

    pd_sym, pd_sc = [], []
    for q in order[:n_cce * 9]:
        pd_sym += [reg_sym[q]] * 4
        pd_sc += list(reg_sc[q])

    pcfich_sym = np.asarray(pcfich_sym, np.int32)
    pcfich_sc = np.asarray(pcfich_sc, np.int32)
    pd_sym = np.asarray(pd_sym, np.int32)
    pd_sc = np.asarray(pd_sc, np.int32)
    return ControlRegionMap(
        fp=fp, n_pdcch=n_pdcch, n_cce=n_cce,
        pcfich_sym=pcfich_sym, pcfich_sc=pcfich_sc,
        pcfich_bin=fp.sc_to_bin(pcfich_sc),
        pdcch_sym=pd_sym, pdcch_sc=pd_sc, pdcch_bin=fp.sc_to_bin(pd_sc))
