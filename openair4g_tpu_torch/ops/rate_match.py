"""Rate matching, 3GPP TS 36.212 §5.1.4 (counterpart of
openair4g_tpu/ops/rate_match.py).

The sub-block-interleave -> circular-buffer -> bit-selection pipeline is
data-independent given (K, F, rv, E, Ncb), so it is built on the host as
index maps. The device side is one gather (TX), a fold of repetitions plus
a static roll into the order-space soft buffer (RX, with the HARQ add),
and one gather back to the d streams.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..device import device_plan

# 36.212 Table 5.1.4-1 inter-column permutation pattern for C_TC = 32.
PERM32 = np.array([0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
                   1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
                  np.int32)

NSOFT_DEFAULT = 1827072  # UE category 3 soft buffer


@functools.lru_cache(maxsize=None)
def _w_maps(D: int, F: int):
    """Sub-block interleaver maps for stream length D with F filler bits.

    Returns (w_src [3*Kpi] int32 index into d_flat[3*D] or -1 for NULL,
             Kpi).
    w layout: w[0:Kpi] = v0; w[Kpi + 2j] = v1[j]; w[Kpi + 2j + 1] = v2[j].
    """
    R = -(-D // 32)
    Kpi = 32 * R
    ND = Kpi - D
    k = np.arange(Kpi)
    c, r = k // R, k % R
    # streams 0/1: v[k] = y[r*32 + PERM32[c]], y = [ND nulls | d]
    y01 = r * 32 + PERM32[c]
    # stream 2: v2[k] = y[(PERM32[k//R] + 32*(k%R) + 1) mod Kpi]
    y2 = (PERM32[c] + 32 * r + 1) % Kpi

    def to_src(ypos: np.ndarray, stream: int, has_filler_null: bool):
        dpos = ypos - ND
        valid = dpos >= 0
        if has_filler_null:
            valid &= dpos >= F
        return np.where(valid, stream * D + dpos, -1).astype(np.int32)

    w_src = np.empty(3 * Kpi, np.int32)
    w_src[:Kpi] = to_src(y01, 0, True)
    w_src[Kpi::2] = to_src(y01, 1, True)
    w_src[Kpi + 1::2] = to_src(y2, 2, False)
    return w_src, Kpi


def compute_ncb(K: int, C: int) -> int:
    """Downlink soft buffer size per code block (36.212 §5.1.4.1.2), for a
    category-3 UE, one transport block per TTI and 8 HARQ processes."""
    Kw = 3 * (32 * (-(-(K + 4) // 32)))
    nir = NSOFT_DEFAULT // 8
    return min(nir // C, Kw)


def block_e_sizes(G: int, C: int, Qm: int) -> list:
    """Per-code-block rate-matching output sizes E (36.212 §5.1.4.1.2), one
    layer."""
    Gp = G // Qm
    gamma = Gp % C
    e_small = Qm * (Gp // C)
    e_big = Qm * (-(-Gp // C))
    return [e_small if r <= C - 1 - gamma else e_big for r in range(C)]


@dataclass(frozen=True)
class RateMatchMaps:
    """Static index maps for one (K, F, rv, E) rate-matching configuration."""
    K: int
    F: int
    rv: int
    E: int
    Ncb: int
    L: int                  # non-NULL positions within Ncb (order space)
    r_off: int              # this rv's rotation within the base emit order
    e_src: np.ndarray       # [E] index into d_flat [3*(K+4)] (TX gather)
    d_from_order: np.ndarray  # [3*(K+4)] order-space index of each d bit,
                              # -1 if never transmitted


@functools.lru_cache(maxsize=None)
def make_rate_match_maps(K: int, F: int, rv: int, E: int,
                         Ncb: int | None = None) -> RateMatchMaps:
    D = K + 4
    w_src, Kpi = _w_maps(D, F)
    if Ncb is None:
        Ncb = 3 * Kpi
    R = Kpi // 32
    # k0 per 36.212: R*(2*ceil(Ncb/(8R))*rv + 2)
    k0 = R * (2 * (-(-Ncb // (8 * R))) * rv + 2)
    cyc = (k0 + np.arange(Ncb)) % Ncb
    order = cyc[w_src[cyc] >= 0]           # non-NULL w positions, emit order
    reps = -(-E // len(order))
    e_src = w_src[np.tile(order, reps)[:E]]
    # Base (rv-independent) emit order = non-NULL positions of [0, Ncb) in
    # increasing w order; every rv's order is that sequence rotated by r_off.
    order_base = np.nonzero(w_src[:Ncb] >= 0)[0]
    L = len(order_base)
    r_off = int(np.searchsorted(order_base, k0 % Ncb))
    d_from_order = np.full(3 * D, -1, np.int32)
    d_from_order[w_src[order_base]] = np.arange(L, dtype=np.int32)
    return RateMatchMaps(K=K, F=F, rv=rv, E=E, Ncb=Ncb, L=L, r_off=r_off,
                         e_src=e_src, d_from_order=d_from_order)


@dataclass(frozen=True)
class CCRateMatchMaps:
    """Index maps for convolutionally-coded channels (36.212 §5.1.4.2)."""
    D: int
    E: int
    L: int                  # non-NULL circular-buffer length
    e_src: np.ndarray       # [E] int32 into d_flat [3*D] (TX gather)
    d_from_order: np.ndarray  # [3*D] int32 order-space index of each d bit


@functools.lru_cache(maxsize=None)
def make_cc_rate_match_maps(D: int, E: int) -> CCRateMatchMaps:
    """CC sub-block interleaver + circular buffer: the same PERM32 for all
    three streams, w = [v0|v1|v2], k0 = 0, NULLs skipped."""
    R = -(-D // 32)
    Kpi = 32 * R
    k = np.arange(Kpi)
    c, r = k // R, k % R
    dpos = r * 32 + PERM32[c] - (Kpi - D)
    v = np.where(dpos >= 0, dpos, -1).astype(np.int32)
    w_src = np.concatenate([np.where(v >= 0, s * D + v, -1)
                            for s in range(3)]).astype(np.int32)
    order_base = np.nonzero(w_src >= 0)[0]
    L = len(order_base)
    reps = -(-E // L)
    e_src = w_src[np.tile(order_base, reps)[:E]]
    d_from_order = np.full(3 * D, -1, np.int32)
    d_from_order[w_src[order_base]] = np.arange(L, dtype=np.int32)
    return CCRateMatchMaps(D=D, E=E, L=L, e_src=e_src,
                           d_from_order=d_from_order)


def _fold(e_llr, L: int):
    """[B, E] -> [B, L]: zero-pad to a whole number of L and sum repeats."""
    B, E = e_llr.shape
    reps = -(-E // L)
    if reps * L != E:
        e_llr = torch.cat(
            [e_llr, torch.zeros(B, reps * L - E, dtype=e_llr.dtype,
                                device=e_llr.device)], dim=1)
    return e_llr.reshape(B, reps, L).sum(dim=1) if reps > 1 \
        else e_llr.reshape(B, L)


def _order_idx(d_from_order: np.ndarray) -> np.ndarray:
    return np.where(d_from_order >= 0, d_from_order, 0)


def _order_mask(d_from_order: np.ndarray) -> np.ndarray:
    return (d_from_order >= 0).astype(np.float32)


def _order_to_d(folded, d_from_order: np.ndarray):
    dev = folded.device
    idx = device_plan(d_from_order, dev, _order_idx, torch.long)
    return folded[:, idx] * device_plan(d_from_order, dev, _order_mask)


def cc_rate_match_rx(e_llr, maps: CCRateMatchMaps):
    """e_llr [B, E] -> d stream LLRs [B, 3, D] (repetitions soft-combined)."""
    folded = _fold(e_llr, maps.L)
    return _order_to_d(folded, maps.d_from_order).reshape(-1, 3, maps.D)


def rate_match_tx(d_flat, maps: RateMatchMaps):
    """d_flat [B, 3*(K+4)] -> e [B, E]. One gather."""
    return d_flat[:, device_plan(maps.e_src, d_flat.device,
                                 dtype=torch.long)]


def rate_match_rx(e_llr, maps: RateMatchMaps, w_soft=None):
    """e_llr [B, E] -> order-space soft buffer [B, L]; `w_soft` from an
    earlier HARQ round (any rv) is added (soft combining)."""
    contrib = torch.roll(_fold(e_llr, maps.L), maps.r_off, dims=1)
    return contrib if w_soft is None else w_soft + contrib


def w_to_d_llr(w_soft, maps: RateMatchMaps):
    """order-space w_soft [B, L] -> d stream LLRs [B, 3, K+4]. Fillers (the
    first F systematic bits, known zeros) get +1e4; never-sent positions 0."""
    d_llr = _order_to_d(w_soft, maps.d_from_order).reshape(
        -1, 3, maps.K + 4)
    if maps.F:
        d_llr[:, 0, :maps.F] = 1e4
    return d_llr
