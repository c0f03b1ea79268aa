"""3GPP TS 36.212 §5.1.3.2 turbo codec (counterpart of
openair4g_tpu/ops/turbo.py).

Encoder: the RSC constituent encoders are linear over GF(2) with a
period-7 impulse response, so each parity stream is a stride-7 prefix-XOR
(one cumsum) and only the 3-step trellis termination needs a table.
Decoder: windowed max-log-MAP, two half-iterations per iteration on the
hand-written kernel (turbo_cuda.half_iteration), a gather QPP permute,
and a per-block CRC latch with a host-checked early exit.

LLR sign convention: LLR = log P(bit=0)/P(bit=1).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..device import device_plan
from ..tables.qpp import QPP_BY_K

from .crc import crc_matrix, crc_remainder
from .turbo_cuda import BIG, half_iteration


def _trellis():
    """RSC g0 = 1+D^2+D^3 feedback, g1 = 1+D+D^3. State s = r1*4+r2*2+r3;
    input u: a = u^r2^r3, parity z = a^r1^r3, next = a*4 + r1*2 + r2."""
    nxt = np.zeros((8, 2), np.int32)
    par = np.zeros((8, 2), np.int32)
    for s in range(8):
        r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for u in (0, 1):
            a = u ^ r2 ^ r3
            nxt[s, u] = a * 4 + r1 * 2 + r2
            par[s, u] = a ^ r1 ^ r3
    return nxt, par


NEXT_STATE, PARITY = _trellis()


@functools.lru_cache(maxsize=None)
def qpp_interleaver(K: int) -> np.ndarray:
    """pi[j] = (f1*j + f2*j^2) mod K: decoder-2 position j reads input pi[j]
    (cached: one array per K, so its device copy is made once)."""
    f1, f2 = QPP_BY_K[K]
    j = np.arange(K, dtype=np.int64)
    return ((f1 * j + f2 * j * j) % K).astype(np.int32)


def _rsc_encode_host(bits: np.ndarray):
    """bits [K] -> (x [K+3], z [K+3]) of one RSC, serially, terminated in
    state 0 (the host's golden encoder, for tests and config-time
    vectors)."""
    K = len(bits)
    x = np.zeros(K + 3, np.int8)
    z = np.zeros(K + 3, np.int8)
    s = 0
    for k in range(K):
        u = int(bits[k])
        r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        a = u ^ r2 ^ r3
        x[k] = u
        z[k] = a ^ r1 ^ r3
        s = a * 4 + r1 * 2 + r2
    for k in range(K, K + 3):  # termination: force a=0 => u = r2^r3
        r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        u = r2 ^ r3
        x[k] = u
        z[k] = 0 ^ r1 ^ r3      # a = 0
        s = r1 * 2 + r2         # a*4 = 0
    assert s == 0, "trellis must terminate in state 0"
    return x, z


def turbo_encode_host(bits: np.ndarray) -> np.ndarray:
    """bits [K] {0,1} -> d [3, K+4] streams per 36.212 §5.1.3.2.2.

    Filler handling is the caller's job (fillers are encoded as zeros and
    the rate matcher marks their d0/d1 positions <NULL>).
    """
    K = len(bits)
    pi = qpp_interleaver(K)
    x1, z1 = _rsc_encode_host(bits)
    x2, z2 = _rsc_encode_host(np.asarray(bits)[pi])
    d = np.zeros((3, K + 4), np.int8)
    d[0, :K] = x1[:K]
    d[1, :K] = z1[:K]
    d[2, :K] = z2[:K]
    # Tail interlacing per 36.212 (d_K..d_{K+3} columns):
    d[0, K:] = [x1[K], z1[K + 1], x2[K], z2[K + 1]]
    d[1, K:] = [z1[K], x1[K + 2], z2[K], x2[K + 2]]
    d[2, K:] = [x1[K + 1], z1[K + 2], x2[K + 1], z2[K + 2]]
    return d


# h[d] = 1 for d >= 1 iff d mod 7 in {1,2,3,6}; h[0] = 1.
_H_SHIFTS = (1, 2, 3, 6)
# bit b of the state after d steps is 1 iff d mod 7 in _STATE_RES[b]
_STATE_RES = {4: (1, 3, 4, 5), 2: (2, 4, 5, 6), 1: (0, 3, 5, 6)}


def _rsc_encode_scan(bits):
    """bits [B, K] int {0,1} -> (z [B, K] parity, s [B] final state).

    P[k] = XOR of bits[k], bits[k-7], ... (a [B, M, 7] cumsum); then
    z[t] = u[t] ^ P[t-1] ^ P[t-2] ^ P[t-3] ^ P[t-6], and the final state
    bits are parity-selected residue-class totals."""
    B, K = bits.shape
    M = -(-K // 7)
    u = torch.cat([bits, bits.new_zeros(B, M * 7 - K)], dim=1).to(torch.int64)
    Pc = torch.cumsum(u.reshape(B, M, 7), dim=1)
    P = torch.remainder(Pc.reshape(B, M * 7)[:, :K], 2)
    z = bits.to(torch.int64)
    for r in _H_SHIFTS:
        z = z + torch.cat([P.new_zeros(B, r), P[:, :K - r]], dim=1)
    z = torch.remainder(z, 2)
    Pm = torch.remainder(Pc[:, M - 1, :], 2)                    # [B, 7]
    vals, sel = _state_select(K % 7)
    sel = device_plan(sel, bits.device)                         # [3, 7]
    s = (torch.remainder((Pm[:, None, :] * sel).sum(dim=-1), 2)
         * device_plan(vals, bits.device)).sum(dim=-1)
    return z.to(torch.int32), s


@functools.lru_cache(maxsize=None)
def _state_select(k_mod7: int):
    """(state bit values [3], residue-class selectors [3, 7]) for K with
    K mod 7 = k_mod7: state bit b is the parity of the classes selected."""
    vals = np.asarray(list(_STATE_RES), np.int64)
    sel = np.asarray([[1 if (k_mod7 - c) % 7 in res else 0 for c in range(7)]
                      for res in _STATE_RES.values()], np.int64)
    return vals, sel


@functools.lru_cache(maxsize=None)
def _tail_tables():
    """Per final state: tail input bits x[3] and parities z[3]."""
    tx = np.zeros((8, 3), np.int32)
    tz = np.zeros((8, 3), np.int32)
    for s0 in range(8):
        s = s0
        for t in range(3):
            r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
            tx[s0, t] = r2 ^ r3
            tz[s0, t] = r1 ^ r3
            s = r1 * 2 + r2
    return tx, tz


def turbo_encode_device(bits, pi: np.ndarray):
    """bits [B, K] int32 -> d [B, 3, K+4] int32. `pi` = qpp_interleaver(K)."""
    B, K = bits.shape
    dev = bits.device
    bits = bits.to(torch.int32)
    bits2 = bits[:, device_plan(pi, dev, dtype=torch.long)]
    z1f, s1 = _rsc_encode_scan(bits)
    z2f, s2 = _rsc_encode_scan(bits2)
    tx, tz = (device_plan(t, dev) for t in _tail_tables())
    x1 = torch.cat([bits, tx[s1]], dim=1)
    z1 = torch.cat([z1f, tz[s1]], dim=1)
    x2 = torch.cat([bits2, tx[s2]], dim=1)
    z2 = torch.cat([z2f, tz[s2]], dim=1)
    d0 = torch.cat([x1[:, :K], x1[:, K:K + 1], z1[:, K + 1:K + 2],
                    x2[:, K:K + 1], z2[:, K + 1:K + 2]], dim=1)
    d1 = torch.cat([z1[:, :K], z1[:, K:K + 1], x1[:, K + 2:K + 3],
                    z2[:, K:K + 1], x2[:, K + 2:K + 3]], dim=1)
    d2 = torch.cat([z2[:, :K], x1[:, K + 1:K + 2], z1[:, K + 2:K + 3],
                    x2[:, K + 1:K + 2], z2[:, K + 2:K + 3]], dim=1)
    return torch.stack([d0, d1, d2], dim=1)


def _permute(x, K: int, inverse: bool):
    """QPP (de)interleave as a gather: y[:, j] = x[:, pi[j]] (or inverse)."""
    return x[:, device_plan(qpp_interleaver(K), x.device,
                            _inverse_perm if inverse else None, torch.long)]


def _inverse_perm(pi: np.ndarray) -> np.ndarray:
    idx = np.empty(len(pi), np.int64)
    idx[pi] = np.arange(len(pi))
    return idx


@dataclass(frozen=True)
class TurboDecoderConfig:
    K: int                 # code block size (bits, incl. any CRC)
    F: int = 0             # filler bits at block head (known zeros)
    n_iter: int = 8        # full iterations
    window: int = 96       # W: trellis window length
    warmup: int = 24       # U: window warm-up overlap
    crc_kind: str = "crc24a"   # CRC at the block tail for the latch
    dynamic_stop: bool = True  # leave the loop once every block latched


def _padded_len(KT: int, W: int) -> int:
    return -(-KT // W) * W


def _make_crc_checker(n_payload: int, kind: str):
    H = crc_matrix(n_payload, kind)

    def check(bits):
        # payload = last n_payload positions (fillers at the head)
        rem = crc_remainder(bits[:, bits.shape[1] - n_payload:], H)
        return torch.all(rem < 0.5, dim=-1)

    return check


def turbo_decode(llr_d, cfg: TurboDecoderConfig):
    """Batched turbo decode.

    llr_d: [B, 3, K+4] float32 LLRs of the d0/d1/d2 streams. Returns
    (bits [B, K] int32, crc_ok [B] bool); each block's decisions are
    latched at the first iteration whose CRC passes. With dynamic_stop the
    loop ends once every block has latched (one host sync per iteration);
    the outputs equal those of the fixed n_iter loop.
    """
    K = cfg.K
    W, U = cfg.window, cfg.warmup
    KT = K + 3
    N = _padded_len(KT, W)
    B = llr_d.shape[0]
    dev = llr_d.device
    llr_d = llr_d.to(torch.float32)
    d0, d1, d2 = llr_d[:, 0], llr_d[:, 1], llr_d[:, 2]
    # de-interlace the tails (36.212 tail mapping)
    sys1 = torch.cat([d0[:, :K], d0[:, K:K + 1], d2[:, K:K + 1],
                      d1[:, K + 1:K + 2]], dim=1)
    par1 = torch.cat([d1[:, :K], d1[:, K:K + 1], d0[:, K + 1:K + 2],
                      d2[:, K + 1:K + 2]], dim=1)
    sys2_tail = torch.cat([d0[:, K + 2:K + 3], d2[:, K + 2:K + 3],
                           d1[:, K + 3:K + 4]], dim=1)
    par2 = torch.cat([d2[:, :K], d1[:, K + 2:K + 3], d0[:, K + 3:K + 4],
                      d2[:, K + 3:K + 4]], dim=1)
    sys_ch = sys1[:, :K]
    pad = torch.full((B, N - KT), BIG, device=dev)
    par1_p = torch.cat([par1, pad], dim=1)
    par2_p = torch.cat([par2, pad], dim=1)
    tail1 = sys1[:, K:]
    crc_ok_fn = _make_crc_checker(K - cfg.F, cfg.crc_kind)

    la1 = torch.zeros(B, K, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    bits_latched = torch.zeros(B, K, dtype=torch.int32, device=dev)
    for _ in range(cfg.n_iter):
        lin1 = torch.cat([sys_ch + la1, tail1, pad], dim=1)
        llr1 = half_iteration(lin1, par1_p, W, U)
        ext1 = llr1[:, :K] - lin1[:, :K]
        apri2 = _permute(sys_ch + ext1, K, inverse=False)
        lin2 = torch.cat([apri2, sys2_tail, pad], dim=1)
        llr2 = half_iteration(lin2, par2_p, W, U)
        ext2 = llr2[:, :K] - lin2[:, :K]
        la1 = _permute(ext2, K, inverse=True)
        llr_final = sys_ch + ext1 + la1
        bits = (llr_final < 0).to(torch.int32)
        ok = crc_ok_fn(bits)
        newly = ok & ~done
        bits_latched = torch.where(newly[:, None], bits, bits_latched)
        done = done | ok
        if cfg.dynamic_stop and bool(done.all()):
            break
    return bits_latched, done
