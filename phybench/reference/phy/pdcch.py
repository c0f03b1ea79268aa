"""PDCCH/DCI and PCFICH coding and the DCI blind decode (counterpart of
openair4g_tpu/phy/pdcch.py): the CFI codewords and their correlation
decoder, the format-1A payload, CRC16 masked by the RNTI, tail-biting CC,
rate matching to 72 L bits; the blind search decodes every candidate
(aggregation L, CCE offset) in one call of ops/convcode.viterbi_search: on
the card one launch, the de-rate-matching in its load phase.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import device_plan
from ..ops.convcode import conv_encode_host, viterbi_search
from ..ops.crc import crc_bits_host, crc_matrix, crc_remainder
from ..ops.gold import gold_sequence
from ..ops.rate_match import make_cc_rate_match_maps

BITS_PER_CCE = 72        # 9 REGs x 4 REs, QPSK

# 36.212 Table 5.3.4-1: the 32-bit PCFICH codewords for CFI 1..3
_CFI_CODEWORDS = np.array([
    [0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0,
     1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1],
    [1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1,
     0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0],
    [1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1,
     1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1]], np.int8)


def cfi_encode(cfi: int) -> np.ndarray:
    """CFI (1..3) -> 32 bits."""
    return _CFI_CODEWORDS[cfi - 1]


def _riv_bits(n_rb_dl: int) -> int:
    return math.ceil(math.log2(n_rb_dl * (n_rb_dl + 1) / 2))


def pack_dci_format1a(n_rb_dl: int, rb_start: int, n_prb: int, mcs: int,
                      harq_pid: int, ndi: int, rv: int, tpc: int = 0,
                      tdd: bool = False, dai: int = 0) -> np.ndarray:
    """Pack a format-1A DCI (localized VRB, RIV per 36.213 §7.1.6.3);
    tdd=True takes the TDD fields (4-bit HARQ process, 2-bit DAI)."""
    if not 1 <= n_prb <= n_rb_dl - rb_start:
        raise ValueError(f"allocation {rb_start}+{n_prb} outside {n_rb_dl} RB")
    if (n_prb - 1) <= n_rb_dl // 2:
        riv = n_rb_dl * (n_prb - 1) + rb_start
    else:
        riv = n_rb_dl * (n_rb_dl - n_prb + 1) + (n_rb_dl - 1 - rb_start)
    fields = [(1, 1), (riv, _riv_bits(n_rb_dl)), (mcs, 5),
              (harq_pid, 4 if tdd else 3), (ndi, 1), (rv, 2), (tpc, 2)]
    if tdd:
        fields.append((dai, 2))
    bits = []
    for val, width in fields:
        bits += [(val >> (width - 1 - i)) & 1 for i in range(width)]
    return np.asarray(bits, np.int8)


@functools.lru_cache(maxsize=None)
def _rnti_bits(rnti: int) -> np.ndarray:
    return np.array([(rnti >> (15 - i)) & 1 for i in range(16)], np.int8)


def dci_encode(payload: np.ndarray, rnti: int, L: int) -> np.ndarray:
    """payload [A] -> coded bits [72*L] (CRC16 xor RNTI, TBCC, rate match)."""
    crc = crc_bits_host(payload, "crc16")
    b = np.concatenate([payload.astype(np.int8), crc ^ _rnti_bits(rnti)])
    d = conv_encode_host(b)
    maps = make_cc_rate_match_maps(len(b), BITS_PER_CCE * L)
    return d.reshape(-1)[maps.e_src]


def pdcch_scramble_seq(nid_cell: int, ns: int, length: int) -> np.ndarray:
    """36.211 §6.8.2: c_init = (ns/2)*2^9 + Nid."""
    return gold_sequence(((ns // 2) << 9) + nid_cell, length).astype(np.int8)


@dataclass(frozen=True)
class DciCandidate:
    L: int
    cce_offset: int


def yk_hash(rnti: int, subframe: int) -> int:
    """36.213 §9.1.1 UE-specific search-space hash Y_k."""
    y = rnti
    for _ in range(subframe + 1):
        y = (y * 39827) % 65537
    return y


def ue_search_candidates(n_cce: int, rnti: int, subframe: int) -> list:
    """UE-specific search space, 36.213 Table 9.1.1-1: M(L) = 6/6/2/2
    candidates at L = 1/2/4/8."""
    cands, seen = [], set()
    for L, M in ((1, 6), (2, 6), (4, 2), (8, 2)):
        if n_cce < L:
            continue
        m_max = min(M, n_cce // L)
        yk = yk_hash(rnti, subframe) % (n_cce // L)
        for m in range(m_max):
            off = L * ((yk + m) % (n_cce // L))
            if (L, off) not in seen:
                seen.add((L, off))
                cands.append(DciCandidate(L=L, cce_offset=off))
    return cands


def common_search_candidates(n_cce: int) -> list:
    """Common search space: L=4 x 4 and L=8 x 2 candidates from CCE 0."""
    cands = []
    for L, M in ((4, 4), (8, 2)):
        for m in range(M):
            if L * m + L <= n_cce:
                cands.append(DciCandidate(L=L, cce_offset=L * m))
    return cands


def dci_blind_decode(llr_cces, payload_len: int, rnti: int,
                     candidates: list):
    """Blind-decode all candidates for one DCI payload size.

    llr_cces: [B, n_cce * 72] descrambled control-region LLRs.
    Returns (found [B] bool, payload_bits [B, payload_len] int8,
    cand_idx [B]): the first candidate whose RNTI-masked CRC checks."""
    B = llr_cces.shape[0]
    dev = llr_cces.device
    K = payload_len + 16
    cands = tuple((c.cce_offset * BITS_PER_CCE, BITS_PER_CCE * c.L)
                  for c in candidates)
    bits = viterbi_search(llr_cces, K, cands)            # [n_cand*B, K]
    crc_calc = crc_remainder(bits[:, :payload_len],
                             crc_matrix(payload_len, "crc16"))
    expect = torch.remainder(
        bits[:, payload_len:].to(torch.float32)
        + device_plan(_rnti_bits(rnti), dev, dtype=torch.float32),
        2.0)
    ok = torch.all(crc_calc == expect, dim=-1)
    ok_c = ok.reshape(len(candidates), B)
    cand_idx = torch.argmax(ok_c.to(torch.int32), dim=0)
    found = ok_c.any(dim=0)
    sel = cand_idx * B + torch.arange(B, device=dev)
    return found, bits[sel][:, :payload_len], cand_idx
