"""PBCH: MIB encode and decode with blind antenna-count and frame-phase
detection, 36.212 §5.3.1 / 36.211 §6.6 (counterpart of
openair4g_tpu/phy/pbch.py).

The four frame-phase hypotheses ride the batch axis of one Viterbi call;
the CRC16, unmasked by each antenna count's mask, picks the winner.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..device import device_plan
from ..ops.convcode import conv_encode_host, viterbi_decode
from ..ops.crc import crc_bits_host, crc_matrix, crc_remainder
from ..ops.gold import gold_sequence
from ..ops.rate_match import cc_rate_match_rx, make_cc_rate_match_maps

MIB_LEN = 24
_K = MIB_LEN + 16          # 40 bits into the CC
_E_NCP = 1920              # rate-matched bits, normal CP (4 frames x 480)

# CRC masks per antenna count (36.212 §5.3.1.1)
_ANT_MASK = {1: np.zeros(16, np.int8),
             2: np.ones(16, np.int8),
             4: np.tile([0, 1], 8).astype(np.int8)}

_BW_TABLE = (6, 15, 25, 50, 75, 100)


def pack_mib(n_rb: int, sfn: int, phich_dur: int = 0,
             phich_res: int = 0) -> np.ndarray:
    """MIB a(0..23): bw(3) | phich_dur(1) | phich_res(2) | SFN[9:2](8) |
    spare(10) (36.331 MasterInformationBlock)."""
    bits = np.zeros(MIB_LEN, np.int8)
    bw = _BW_TABLE.index(n_rb)
    bits[0:3] = [(bw >> (2 - i)) & 1 for i in range(3)]
    bits[3] = phich_dur & 1
    bits[4:6] = [(phich_res >> (1 - i)) & 1 for i in range(2)]
    sfn8 = (sfn >> 2) & 0xFF
    bits[6:14] = [(sfn8 >> (7 - i)) & 1 for i in range(8)]
    return bits


def unpack_mib(bits: np.ndarray) -> dict:
    bw = int(bits[0]) * 4 + int(bits[1]) * 2 + int(bits[2])
    sfn8 = 0
    for i in range(8):
        sfn8 = (sfn8 << 1) | int(bits[6 + i])
    return dict(n_rb=_BW_TABLE[bw] if bw < 6 else None,
                phich_dur=int(bits[3]),
                phich_res=int(bits[4]) * 2 + int(bits[5]),
                sfn_msb8=sfn8)


def pbch_encode(mib_bits: np.ndarray, n_ant: int = 1) -> np.ndarray:
    """MIB -> the 1920 coded bits of one 40 ms period."""
    crc = crc_bits_host(mib_bits, "crc16") ^ _ANT_MASK[n_ant]
    b = np.concatenate([mib_bits.astype(np.int8), crc])
    d = conv_encode_host(b)                      # [3, 40]
    return d.reshape(-1)[make_cc_rate_match_maps(_K, _E_NCP).e_src]


@functools.lru_cache(maxsize=None)
def pbch_scramble_seq(nid_cell: int) -> np.ndarray:
    """Gold sequence over the 40 ms PBCH period (36.211 §6.6.1)."""
    return gold_sequence(nid_cell, _E_NCP).astype(np.int8)


@dataclass(frozen=True, eq=False)
class PbchMap:
    """RE coordinates of one frame's PBCH quarter (240 QPSK symbols)."""
    sym: np.ndarray       # subframe-0 symbol indices (slot 1 => 7..10)
    sc: np.ndarray        # occupied-grid subcarrier indices
    bins: np.ndarray


@functools.lru_cache(maxsize=None)
def make_pbch_map(n_rb: int, nid_cell: int = 0,
                  normal_cp: bool = True) -> PbchMap:
    """Center 72 SCs on slot-1 symbols 0..3; symbols 0/1 skip the 4-port RS
    lattice (k = nushift mod 3, spacing 3) => 48+48+72+72 = 240 REs."""
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp, n_id_cell=nid_cell)
    base = 6 * n_rb - 36
    rs_mod3 = nid_cell % 3
    sym_l, sc_l = [], []
    for l in range(4):
        for k in range(72):
            if l < 2 and (k % 3) == rs_mod3:
                continue
            sym_l.append(fp.symbols_per_slot + l)
            sc_l.append(base + k)
    sc = np.asarray(sc_l, np.int32)
    return PbchMap(sym=np.asarray(sym_l, np.int32), sc=sc,
                   bins=fp.sc_to_bin(sc))


def pbch_frame_symbols(mib_bits: np.ndarray, nid_cell: int, frame_phase: int,
                       n_ant: int = 1) -> np.ndarray:
    """QPSK symbols [240] for radio frame (sfn mod 4 == frame_phase)."""
    e = pbch_encode(mib_bits, n_ant)
    b = e ^ pbch_scramble_seq(nid_cell)
    q = b[480 * frame_phase: 480 * (frame_phase + 1)].astype(np.float64)
    s = ((1 - 2 * q[0::2]) + 1j * (1 - 2 * q[1::2])) / np.sqrt(2)
    return s.astype(np.complex64)


def _signs(seq: np.ndarray) -> np.ndarray:
    return 1.0 - 2.0 * seq.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ant_masks(n_ant_hyps: tuple) -> np.ndarray:
    return np.stack([_ANT_MASK[na] for na in n_ant_hyps]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _hyps(n_ant_hyps: tuple) -> np.ndarray:
    return np.asarray(n_ant_hyps, np.int64)


def pbch_blind_decode(llr480, nid_cell: int, n_ant_hyps=(1, 2)):
    """Blind-decode one frame's PBCH quarter.

    llr480: [B, 480] LLRs (positive <=> bit 0) of the received quarter.
    Each of the 4 frame phases descrambles the quarter into its place of
    the 1920-bit period (the rest 0), all decoded as one batch; a phase's
    CRC16 checks under some antenna mask. Returns (ok [B], mib_bits
    [B, 24], phase [B], n_ant [B]): the first phase that checks, and the
    first antenna count of `n_ant_hyps` that does."""
    B = llr480.shape[0]
    dev = llr480.device
    sgn = device_plan(pbch_scramble_seq(nid_cell), dev, _signs)
    e_all = llr480.new_zeros(4, B, _E_NCP)
    for ph in range(4):
        q = slice(480 * ph, 480 * (ph + 1))
        e_all[ph, :, q] = llr480 * sgn[q]
    d_llr = cc_rate_match_rx(e_all.reshape(4 * B, _E_NCP),
                             make_cc_rate_match_maps(_K, _E_NCP))
    bits = viterbi_decode(d_llr, _K)                     # [4B, 40]
    payload = bits[:, :MIB_LEN]
    crc_calc = crc_remainder(payload, crc_matrix(MIB_LEN, "crc16"))
    crc_rx = bits[:, MIB_LEN:].to(torch.float32)
    hyps = tuple(n_ant_hyps)
    masks = device_plan(_ant_masks(hyps), dev)           # [n_hyp, 16]
    ok_h = torch.all(torch.remainder(crc_calc + masks[:, None], 2.0)
                     == crc_rx, dim=-1)                  # [n_hyp, 4B]
    ant_idx = torch.argmax(ok_h.to(torch.int32), dim=0)
    ok_p = ok_h.any(dim=0).reshape(4, B)
    phase = torch.argmax(ok_p.to(torch.int32), dim=0)
    sel = phase * B + torch.arange(B, device=dev)
    ant = device_plan(_hyps(hyps), dev)[ant_idx[sel]]
    return ok_p.any(dim=0), payload[sel], phase, ant
