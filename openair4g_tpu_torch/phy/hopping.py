"""UL sequence-group, sequence and cyclic-shift hopping (36.211 §5.5.1.3-4,
§5.5.2.1.1) and PUSCH frequency hopping (36.211 §5.3.4; 36.213 §8.4)
(counterpart of openair4g_tpu/phy/hopping.py). Every pattern is a small
per-cell constant computed once on the host from the Gold sequence; the
device sees only the resulting DMRS constants and PRB starts.
"""
from __future__ import annotations

import functools

import numpy as np

from ..ops.gold import gold_sequence
from .ulref import zc_base_sequence


@functools.lru_cache(maxsize=None)
def group_hop_pattern(nid_cell: int, enabled: bool = True) -> np.ndarray:
    """f_gh(ns) for ns in [0, 20): 8 Gold bits per slot mod 30
    (36.211 §5.5.1.3, c_init = floor(Nid/30))."""
    if not enabled:
        return np.zeros(20, np.int32)
    c = np.asarray(gold_sequence(nid_cell // 30, 160))
    w = 1 << np.arange(8)
    return (c.reshape(20, 8) @ w % 30).astype(np.int32)


def f_ss_pusch(nid_cell: int, delta_ss: int = 0) -> int:
    return (nid_cell % 30 + delta_ss) % 30


def f_ss_pucch(nid_cell: int) -> int:
    return nid_cell % 30


def pusch_group_number(nid_cell: int, ns: int, group_hopping: bool = True,
                       delta_ss: int = 0) -> int:
    """u(ns) = (f_gh(ns) + f_ss^PUSCH) mod 30."""
    fgh = int(group_hop_pattern(nid_cell, group_hopping)[ns % 20])
    return (fgh + f_ss_pusch(nid_cell, delta_ss)) % 30


@functools.lru_cache(maxsize=None)
def sequence_hop_pattern(nid_cell: int, delta_ss: int = 0,
                         enabled: bool = False) -> np.ndarray:
    """v(ns): base-sequence number hopping (only when group hopping is OFF
    and M_sc >= 6 RB; c_init = floor(Nid/30)*32 + f_ss^PUSCH)."""
    if not enabled:
        return np.zeros(20, np.int32)
    cinit = (nid_cell // 30) * 32 + f_ss_pusch(nid_cell, delta_ss)
    return np.asarray(gold_sequence(cinit, 20), np.int32)


@functools.lru_cache(maxsize=None)
def dmrs_cs_hop_pattern(nid_cell: int, delta_ss: int = 0,
                        nsymb_ul: int = 7) -> np.ndarray:
    """n_PN(ns): per-slot pseudo-random cyclic-shift offset of the PUSCH
    DMRS (36.211 §5.5.2.1.1; c_init = floor(Nid/30)*32 + f_ss^PUSCH)."""
    cinit = (nid_cell // 30) * 32 + f_ss_pusch(nid_cell, delta_ss)
    c = np.asarray(gold_sequence(cinit, 8 * nsymb_ul * 20 * 2))
    w = 1 << np.arange(8)
    out = np.zeros(20, np.int32)
    for ns in range(20):
        out[ns] = int(c[8 * nsymb_ul * 2 * ns: 8 * nsymb_ul * 2 * ns + 8] @ w)
    return out % 12


def pusch_dmrs_slots(m_sc: int, nid_cell: int, subframe: int,
                     n_dmrs1: int = 0, n_dmrs2: int = 0,
                     group_hopping: bool = True, sequence_hopping: bool = False,
                     cs_hopping: bool = True, delta_ss: int = 0) -> np.ndarray:
    """Per-slot PUSCH DMRS [2, m_sc] with group/sequence/CS hopping.

    Generalizes ulref.pusch_dmrs (which is the hopping-off special case)."""
    out = np.zeros((2, m_sc), np.complex64)
    vpat = sequence_hop_pattern(nid_cell, delta_ss,
                                sequence_hopping and not group_hopping
                                and m_sc >= 72)
    cspat = dmrs_cs_hop_pattern(nid_cell, delta_ss) if cs_hopping else \
        np.zeros(20, np.int32)
    for i, ns in enumerate((2 * subframe, 2 * subframe + 1)):
        u = pusch_group_number(nid_cell, ns, group_hopping, delta_ss)
        v = int(vpat[ns % 20])
        ncs = (n_dmrs1 + n_dmrs2 + int(cspat[ns % 20])) % 12
        alpha = 2.0 * np.pi * ncs / 12.0
        n = np.arange(m_sc)
        out[i] = np.exp(1j * alpha * n) * zc_base_sequence(u, v, m_sc)
    return out


# --------------------------------------------- PUSCH frequency hopping --
# 36.211 §5.3.4: the pattern is a host precompute and the RE mapping
# consumes per-slot PRB starts (scfdma.make_pusch_map).

@functools.lru_cache(maxsize=None)
def pusch_hop_pattern(nid_cell: int, n_sb: int,
                      n_hops: int = 20) -> tuple:
    """(f_hop [n_hops], f_m [n_hops]) — the type-2 pseudo-random sub-band
    hopping function and mirroring pattern (36.211 §5.3.4; Gold sequence
    c_init = N_ID_cell). Hop index i is the slot number for
    intra+inter-subframe hopping, the subframe number otherwise."""
    c = np.asarray(gold_sequence(nid_cell, 10 * n_hops + 10), np.int64)
    f_hop = np.zeros(n_hops, np.int32)
    prev = 0
    for i in range(n_hops):
        if n_sb == 1:
            cur = 0
        elif n_sb == 2:
            cur = (prev + int(c[i * 10 + 1])) % n_sb
        else:
            acc = sum(int(c[i * 10 + k]) << (k - 1)
                      for k in range(1, 10)) % (n_sb - 1)
            cur = (prev + acc + 1) % n_sb
        f_hop[i] = cur
        prev = cur
    if n_sb == 1:
        f_m = np.arange(n_hops, dtype=np.int32) % 2
    else:
        f_m = np.asarray([int(c[i * 10]) for i in range(n_hops)], np.int32)
    return tuple(f_hop.tolist()), tuple(f_m.tolist())


def pusch_hopping_region(n_rb_ul: int, n_sb: int, n_rb_ho: int) -> tuple:
    """(first PRB of the hopping region, N_RB_sb sub-band width,
    usable width) — 36.211 §5.3.4: the region excludes N_RB_HO PRBs
    (split across both band edges when N_sb > 1)."""
    if n_sb == 1:
        n_rb_sb = n_rb_ul
        first = 0
    else:
        # 36.211 §5.3.4: N_RB_sb = floor((N_RB_UL - N_RB_HO -
        # (N_RB_HO mod 2)) / N_sb); the region starts at ceil(N_RB_HO / 2)
        n_rb_sb = (n_rb_ul - n_rb_ho - (n_rb_ho % 2)) // n_sb
        first = (n_rb_ho + 1) // 2
    return first, n_rb_sb, n_rb_sb * n_sb


def pusch_hopped_rb_start(rb_start: int, n_prb: int, n_rb_ul: int,
                          hop_i: int, hopping_bits: int,
                          nid_cell: int = 0, n_sb: int = 1,
                          n_rb_ho: int = 0) -> int:
    """PRB start of hop `hop_i` (0 = first slot/subframe, unhopped
    lowest-index allocation from the DCI-0 RIV).

    Type 1 (explicit offset from the DCI hopping bits; 36.213 Table
    8.4-2): 1 bit for N_RB_UL < 50 (0 -> +floor(N/2)), 2 bits otherwise
    (00 -> +floor(N/4), 01 -> -floor(N/4), 10 -> +floor(N/2)); the
    all-ones value selects type 2.  Type 2: pseudo-random sub-band
    hopping with mirroring (pusch_hop_pattern).
    """
    first, n_rb_sb, n_use = pusch_hopping_region(n_rb_ul, n_sb, n_rb_ho)
    nbits = 1 if n_rb_ul < 50 else 2
    type2 = hopping_bits == (1 << nbits) - 1
    n_tilde = rb_start - first           # position inside the region
    if not (0 <= n_tilde and n_tilde + n_prb <= n_use):
        raise ValueError(f"PRBs {rb_start}..{rb_start + n_prb - 1} leave the "
                         f"hopping region {first}..{first + n_use - 1}")
    if hop_i == 0:
        return rb_start
    if not type2:
        # Type 1 alternates: odd hops take the Table 8.4-2 offset from
        # the FIRST-slot position, even hops return to it (36.213 §8.4.1
        # defines n~_PRB(i) from n~_S1, not cumulatively).
        if hop_i % 2 == 0:
            return rb_start
        if nbits == 1:
            off = n_use // 2
        else:
            # 36.213 Table 8.4-2: '01' is -ceil(N/4)
            off = (n_use // 4, -((n_use + 3) // 4), n_use // 2)[hopping_bits]
        return first + (n_tilde + off) % n_use
    f_hop, f_m = pusch_hop_pattern(nid_cell, n_sb)
    i = hop_i % len(f_hop)
    sb = (n_tilde // n_rb_sb + f_hop[i]) % n_sb
    within = n_tilde % n_rb_sb
    if f_m[i]:                           # mirror within the sub-band
        within = n_rb_sb - n_prb - within
    return first + sb * n_rb_sb + within
