"""Tail-biting convolutional code and Viterbi decoder, 36.212 §5.1.3.1
(counterpart of openair4g_tpu/ops/convcode.py): rate 1/3, constraint
length 7, generators {0133, 0171, 0165}. The decoder runs the 64-state
trellis over n_wrap copies of the frame and keeps the middle copy's
traceback (circular decoding, no initial-state bias).

A frozen copy of the port's plain versions: `viterbi_decode` is the plain
trellis loop on any device, and `viterbi_search` the candidate loop of
`cc_rate_match_rx` into it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import device_plan
from .rate_match import cc_rate_match_rx, make_cc_rate_match_maps

_GENS = (0o133, 0o171, 0o165)
N_STATES = 64
# The copies of the frame a DCI search decodes over: viterbi_decode's
# default, which the reference's blind decode takes.
SEARCH_WRAP = 3


def _parity(x: np.ndarray) -> np.ndarray:
    y = x.copy()
    for s in (4, 2, 1):
        y ^= y >> s
    return y & 1


@functools.lru_cache(maxsize=None)
def _tables():
    """Per (input u, state s = b_{k-1}..b_{k-6}): 3 output bits and the
    successor state (u<<5)|(s>>1)."""
    s = np.arange(N_STATES, dtype=np.int64)
    out = np.zeros((2, N_STATES, 3), np.int8)
    nxt = np.zeros((2, N_STATES), np.int32)
    for u in (0, 1):
        reg = (u << 6) | s
        for i, g in enumerate(_GENS):
            out[u, :, i] = _parity(reg & g)
        nxt[u] = (u << 5) | (s >> 1)
    return out, nxt


@functools.lru_cache(maxsize=None)
def _pred_outputs() -> np.ndarray:
    """[64, 2, 3] output bits of the transition from predecessor
    2*(s'&31)+j into s' (input u = s'>>5)."""
    out, _ = _tables()
    pred_out = np.zeros((N_STATES, 2, 3), np.int8)
    for sp in range(N_STATES):
        base = (sp & 31) << 1
        for j in (0, 1):
            pred_out[sp, j] = out[sp >> 5, base + j]
    return pred_out


def conv_encode_host(bits: np.ndarray) -> np.ndarray:
    """Tail-biting rate-1/3 encode. bits [K] {0,1} -> d [3, K] int8."""
    bits = np.asarray(bits, np.int64)
    K = len(bits)
    out, nxt = _tables()
    s = 0
    for j in range(1, 7):
        s |= int(bits[K - j]) << (6 - j)
    d = np.zeros((3, K), np.int8)
    for k in range(K):
        u = int(bits[k])
        d[:, k] = out[u, s]
        s = int(nxt[u, s])
    return d


@functools.lru_cache(maxsize=None)
def _tap_bits() -> np.ndarray:
    """[3, 7] generator bit j of each output: the weight of u_{k-j}."""
    return np.asarray([[(g >> (6 - j)) & 1 for j in range(7)]
                       for g in _GENS], np.int8)


def conv_encode_device(bits):
    """Batched tail-biting encode. bits [B, K] {0,1} -> d [B, 3, K] int8.
    Output i at k is the parity of sum_j g_i[j] u_{(k-j) mod K}, the
    encoder register read circularly (its start state is the last six
    bits), so every position is computed at once."""
    u = bits.to(torch.int8)
    taps = _tap_bits()
    shifted = [torch.roll(u, j, dims=-1) for j in range(7)]   # u_{k-j}
    d = []
    for i in range(3):
        acc = torch.zeros_like(u)
        for j in range(7):
            if taps[i, j]:
                acc = torch.bitwise_xor(acc, shifted[j])
        d.append(acc)
    return torch.stack(d, dim=1)


def _signs(bits: np.ndarray) -> np.ndarray:
    return 1.0 - 2.0 * bits.astype(np.float32)


def viterbi_decode_ref(llrs, K: int, n_wrap: int = 3):
    """Circular Viterbi decode, the plain version of csrc/viterbi.cu.
    llrs [B, 3, K] float (positive <=> bit 0) -> hard decisions [B, K]
    int8. Ties pick the lower predecessor and the lowest final state, as
    the reference's argmax does."""
    B = llrs.shape[0]
    dev = llrs.device
    sign = device_plan(_pred_outputs(), dev, _signs)           # [64, 2, 3]
    x = llrs.to(torch.float32).repeat(1, 1, n_wrap)           # [B, 3, T]
    T = n_wrap * K
    xt = x.permute(2, 0, 1)[:, :, None, None, :]              # [T, B, 1, 1, 3]
    prod = xt * sign                                          # [T, B, 64, 2, 3]
    bm = (prod[..., 0] + prod[..., 1]) + prod[..., 2]         # [T, B, 64, 2]
    metric = torch.zeros(B, N_STATES, device=dev)
    choices = torch.empty(T, B, N_STATES, dtype=torch.int8, device=dev)
    for t in range(T):
        # predecessors of s' are 2*(s'&31)+j: pairs tiled twice
        cand = metric.reshape(B, 32, 2).repeat(1, 2, 1) + bm[t]
        choices[t] = cand[..., 1] > cand[..., 0]
        new = torch.maximum(cand[..., 0], cand[..., 1])
        metric = new - new.max(dim=-1, keepdim=True).values
    state = torch.argmax(metric, dim=-1)
    us = torch.empty(T, B, dtype=torch.int8, device=dev)
    for t in range(T - 1, -1, -1):
        j = choices[t].gather(1, state[:, None])[:, 0].long()
        us[t] = (state >> 5).to(torch.int8)
        state = 2 * (state & 31) + j
    mid = (n_wrap // 2) * K
    return us[mid:mid + K].T


def viterbi_decode(llrs, K: int, n_wrap: int = 3):
    """llrs [R, 3, K] (positive <=> bit 0) -> hard decisions [R, K] int8."""
    if llrs.shape[0] == 0:
        return torch.empty(0, K, dtype=torch.int8, device=llrs.device)
    return viterbi_decode_ref(llrs, K, n_wrap)


def search_llrs_ref(llr_cces, K: int, cands: tuple):
    """The plain version of the search kernel's load phase:
    cc_rate_match_rx of each candidate's E LLRs from `start`, concatenated
    candidate-major. llr_cces [B, W] -> d-stream LLRs [n_cand * B, 3, K]."""
    return torch.cat([cc_rate_match_rx(llr_cces[:, s:s + E],
                                       make_cc_rate_match_maps(K, E))
                      for s, E in cands], dim=0)


def viterbi_search_ref(llr_cces, K: int, cands: tuple):
    """The plain version of the search kernel: the candidate loop into
    viterbi_decode_ref. llr_cces [B, W] -> decisions [n_cand * B, K] int8,
    candidate-major."""
    return viterbi_decode_ref(search_llrs_ref(llr_cces, K, cands), K,
                              SEARCH_WRAP)


def viterbi_search(llr_cces, K: int, cands: tuple):
    """Decode every candidate of one blind search: candidate c's E LLRs
    from `start` of each row of llr_cces [B, W], de-rate-matched to K bits
    (cc_rate_match_rx) and Viterbi-decoded over SEARCH_WRAP copies. cands
    ((start, E), ...) -> decisions [n_cand * B, K] int8, candidate-major:
    viterbi_search_ref on any device; B = 0 returns at once."""
    if llr_cces.shape[0] == 0:
        return torch.empty(0, K, dtype=torch.int8, device=llr_cces.device)
    return viterbi_search_ref(llr_cces, K, cands)
