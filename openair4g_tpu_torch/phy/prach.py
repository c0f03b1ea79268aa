"""PRACH: random-access preamble generation and detection, 36.211 §5.7
(counterpart of openair4g_tpu/phy/prach.py).

RE-level detection correlates the N_ZC PRACH bins with the root's
spectrum and takes one matmul with the inverse DFT; each preamble owns a
cyclic-shift window of the correlation, whose argmax is the delay. The
time-domain path maps between the sample stream and the N_ZC bins with
one matmul against the phasor matrix E[t, m] = exp(2 pi j (k0 + m) t / N)
/ sqrt(N), a unitary pair, built once per shape and uploaded once per
device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import device_plan
from ..tables.prach_root_map import ROOT_ORDER_0_3, ROOT_ORDER_4

N_ZC = 839
N_ZC_F4 = 139           # preamble format 4

# NCS configurations (36.211 Tables 5.7.2-2 / 5.7.2-3), indexed by
# zeroCorrelationZoneConfig. N_CS = 0 means no cyclic-shift limit: one
# preamble per root, the whole N_ZC window its zone.
NCS_UNRESTRICTED = (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119,
                    167, 279, 419)
NCS_RESTRICTED = (15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 128, 158,
                  202, 237)    # high-speed set
NCS_FORMAT4 = (2, 4, 6, 8, 10, 12, 15)

# Preamble format timing at the 30.72 Msps base rate (36.211 Table
# 5.7.1-1): (T_CP samples, T_SEQ samples per repetition, repetitions)
FORMAT_TIMING = {
    0: (3168, 24576, 1),
    1: (21024, 24576, 1),
    2: (6240, 24576, 2),
    3: (21024, 24576, 2),
    4: (448, 4096, 1),
}


@functools.lru_cache(maxsize=None)
def zc_root(u: int, n_zc: int = N_ZC) -> np.ndarray:
    """x_u(n) = exp(-j pi u n(n+1) / N_ZC)."""
    n = np.arange(n_zc, dtype=np.float64)
    return np.exp(-1j * np.pi * u * n * (n + 1) / n_zc).astype(np.complex64)


def preamble(u: int, v: int, ncs: int, n_zc: int = N_ZC) -> np.ndarray:
    """x_{u,v}(n) = x_u((n + C_v) mod N_ZC), C_v = v * NCS (unrestricted)."""
    return np.roll(zc_root(u, n_zc), -v * ncs)


def preamble_shifted(u: int, cv: int, n_zc: int = N_ZC) -> np.ndarray:
    """x_u((n + C_v) mod N_ZC) for an explicit C_v (restricted set)."""
    return np.roll(zc_root(u, n_zc), -cv)


@functools.lru_cache(maxsize=None)
def _dft(n_zc: int = N_ZC) -> np.ndarray:
    """[n_zc, n_zc] unitary DFT matrix (host constant)."""
    n = np.arange(n_zc)
    W = np.exp(-2j * np.pi * np.outer(n, n) / n_zc) / np.sqrt(n_zc)
    return W.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _idft(n_zc: int = N_ZC) -> np.ndarray:
    """The inverse, conj(W)^T, as the correlator multiplies by it."""
    return np.conj(_dft(n_zc)).T.copy()


def preamble_freq(u: int, v: int, ncs: int, n_zc: int = N_ZC) -> np.ndarray:
    """Frequency-domain preamble (what the PRACH grid carries)."""
    return (_dft(n_zc) @ preamble(u, v, ncs, n_zc)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _root_freq_conj(u: int, n_zc: int = N_ZC) -> np.ndarray:
    return np.conj(_dft(n_zc) @ zc_root(u, n_zc)).astype(np.complex64)


def n_preambles(ncs: int, n_zc: int = N_ZC) -> int:
    """Cyclic-shift preambles available per root (unrestricted set)."""
    return n_zc // ncs if ncs else 1


# ------------------------------------------------- restricted (high-speed) --

@functools.lru_cache(maxsize=None)
def zc_du(u: int, n_zc: int = N_ZC) -> int:
    """Doppler cyclic-shift distance d_u (36.211 §5.7.2): p = u^-1 mod
    N_ZC, d_u = min(p, N_ZC - p)."""
    p = pow(u, -1, n_zc)
    return p if p < n_zc - p else n_zc - p


def restricted_shifts(u: int, ncs: int, n_zc: int = N_ZC) -> list[int]:
    """All C_v of the restricted set for root u (36.211 §5.7.2: n_shift,
    d_start, n_group, n_shift_bar; the spec's formula, which the
    reference's prach.c:1747 transcribes with N_ZC for N_CS)."""
    du = zc_du(u, n_zc)
    if ncs <= du < n_zc / 3:
        n_shift = du // ncs
        d_start = 2 * du + n_shift * ncs
        n_group = n_zc // d_start
        n_shift_bar = max(0, (n_zc - 2 * du - n_group * d_start) // ncs)
    elif n_zc / 3 <= du <= (n_zc - ncs) // 2:
        n_shift = (n_zc - 2 * du) // ncs
        d_start = n_zc - 2 * du + n_shift * ncs
        n_group = du // d_start
        n_shift_bar = min(max(0, (du - n_group * d_start) // ncs), n_shift)
    else:
        return []
    total = n_shift * n_group + n_shift_bar
    return [d_start * (v // n_shift) + (v % n_shift) * ncs
            for v in range(total)] if n_shift else []


def preamble_map(root_seq_index: int, ncs_config: int,
                 high_speed: bool = False, fmt: int = 0,
                 count: int = 64) -> list[tuple[int, int]]:
    """The cell's 64 preambles as (physical root u, cyclic shift C_v),
    walking logical root indices from rootSequenceIndex (36.211 §5.7.2).
    The restricted set skips roots with no shift."""
    if fmt < 4:
        order, n_zc = ROOT_ORDER_0_3, N_ZC
        ncs = (NCS_RESTRICTED if high_speed
               else NCS_UNRESTRICTED)[ncs_config]
    else:
        if high_speed:
            raise ValueError("format 4 has no restricted set (36.211)")
        order, n_zc = ROOT_ORDER_4, N_ZC_F4
        ncs = NCS_FORMAT4[ncs_config]
    out: list[tuple[int, int]] = []
    idx = root_seq_index
    while len(out) < count:
        u = order[idx % len(order)]
        if high_speed:
            shifts = restricted_shifts(u, ncs, n_zc)
        else:
            shifts = [v * ncs for v in range(n_preambles(ncs, n_zc))]
        for cv in shifts:
            out.append((u, cv))
            if len(out) == count:
                break
        idx += 1
    return out


# --------------------------------------- prach_ConfigIndex -> occasions --

# FDD subframe patterns of 36.211 Table 5.7.1-2, indexed by
# prach_ConfigIndex % 16: (sfn_mod: 1 = any frame, 2 = even frames only,
# subframes); the format is the index >> 4.
_FDD_PATTERNS = (
    (2, (1,)), (2, (4,)), (2, (7,)),
    (1, (1,)), (1, (4,)), (1, (7,)),
    (1, (1, 6)), (1, (2, 7)), (1, (3, 8)),
    (1, (1, 4, 7)), (1, (2, 5, 8)), (1, (3, 6, 9)),
    (1, (0, 2, 4, 6, 8)), (1, (1, 3, 5, 7, 9)),
    (1, (0, 1, 2, 3, 4, 5, 6, 7, 8, 9)),
    (2, (9,)),
)
# patterns unavailable for formats 1/2 (the table's N/A rows) and the
# format-3 tail
_FDD_NA = {30, 46, 60, 61, 62}
_F3_REMAP = {57: 9, 58: 10, 59: 11}    # format 3 indices 57-59 = p9-p11


def prach_fdd_config(config_index: int):
    """-> (format, sfn_mod, subframes) for an FDD prach_ConfigIndex
    (36.211 Table 5.7.1-2). Raises ValueError on N/A indices."""
    if not 0 <= config_index < 64:
        raise ValueError(f"prach_ConfigIndex {config_index} not in 0..63")
    if config_index in _FDD_NA:
        raise ValueError(f"prach_ConfigIndex {config_index} is N/A (FDD)")
    fmt = config_index >> 4
    p = config_index & 15
    if fmt == 3 and config_index in _F3_REMAP:
        p = _F3_REMAP[config_index]
    if fmt >= 1 and p == 14 and config_index != 14:
        raise ValueError(f"prach_ConfigIndex {config_index} is N/A (FDD)")
    sfn_mod, sfs = _FDD_PATTERNS[p]
    return fmt, sfn_mod, sfs


def is_prach_occasion(config_index: int, sfn: int, subframe: int) -> bool:
    """FDD PRACH occasion test."""
    _, sfn_mod, sfs = prach_fdd_config(config_index)
    return (sfn % sfn_mod == 0) and subframe in sfs


# --------------------------------------------------- RE-level detection --

@functools.lru_cache(maxsize=None)
def _windows(shifts: tuple, win_len: int, n_zc: int) -> np.ndarray:
    """[n_pre, win_len] correlation positions each preamble owns."""
    return np.stack([(np.arange(win_len) - cv) % n_zc for cv in shifts]
                    ).astype(np.int64)


def prach_detect(rx_freq, u: int, ncs: int, threshold: float = 15.0,
                 n_zc: int = N_ZC, shifts: list[int] | None = None):
    """Detect preambles on the N_ZC PRACH bins.

    rx_freq: [B, n_zc] received frequency-domain PRACH. shifts: explicit
    C_v (restricted set); None is the unrestricted grid v * ncs. Returns
    (energy [B, n_pre]: each preamble's peak energy over the noise floor,
    the mean energy; delay [B, n_pre]: the peak's position in ZC samples,
    the first on a tie; detected [B, n_pre]: energy > threshold).

    corr = IDFT(rx .* conj(X_u)); a delay-d arrival of preamble v peaks at
    (d - C_v) mod N_ZC, so v owns the window {j - C_v, j in [0, ncs)}."""
    win_len = ncs if ncs else n_zc
    if shifts is None:
        shifts = [v * ncs for v in range(n_preambles(ncs, n_zc))]
    dev = rx_freq.device
    prod = rx_freq * device_plan(_root_freq_conj(u, n_zc), dev)
    corr = prod @ device_plan(_idft(n_zc), dev)           # [B, n_zc]
    e = corr.abs() ** 2
    floor = torch.mean(e, dim=-1, keepdim=True) + 1e-12
    ew = e[:, device_plan(_windows(tuple(shifts), win_len, n_zc), dev)]
    delay = torch.argmax(ew, dim=-1)                      # [B, n_pre]
    energy = ew.gather(2, delay[..., None])[..., 0] / floor
    return energy, delay, energy > threshold


# ------------------------------------------------- time-domain sample path --

def prach_samples_per_seq(n_fft: int, fmt: int) -> int:
    """Samples of one T_SEQ repetition at fs = n_fft * 15 kHz: 12 n_fft
    for Delta_f_RA = 1.25 kHz (formats 0-3), 2 n_fft for 7.5 kHz (4)."""
    return (12 if fmt < 4 else 2) * n_fft


def prach_cp_samples(n_fft: int, fmt: int) -> int:
    """T_CP at fs = n_fft * 15 kHz."""
    base_cp, _, _ = FORMAT_TIMING[fmt]
    return (base_cp * n_fft) // 2048


def prach_k0(n_ra_prb: int, n_rb_ul: int, fmt: int) -> int:
    """First PRACH bin relative to DC in Delta_f_RA units (36.211 §5.7.3:
    K k0 + phi + K/2)."""
    k = 12 * n_ra_prb - 6 * n_rb_ul            # 15 kHz units rel. DC
    K = 12 if fmt < 4 else 2
    phi = 7 if fmt < 4 else 2
    return K * k + phi + K // 2


@functools.lru_cache(maxsize=None)
def _phasor(n_fft: int, fmt: int, n_ra_prb: int, n_rb_ul: int,
            n_zc: int) -> torch.Tensor:
    """[N, n_zc] complex64 E[t, m] = exp(2 pi j (k0 + m) t / N) / sqrt(N),
    a unitary pair (E^H E = I): generation and detection are exact
    inverses and the per-bin noise variance is the per-sample one. Built
    on the host in float32 as the reference builds it (the argument
    t (k0 + m) reaches about 4.5e4 rad at 20 MHz, so its float32 rounding
    is part of the result), then uploaded once per device."""
    N = prach_samples_per_seq(n_fft, fmt)
    k0 = prach_k0(n_ra_prb, n_rb_ul, fmt)
    t = torch.arange(N, dtype=torch.float32)[:, None]
    m = k0 + torch.arange(n_zc, dtype=torch.float32)[None, :]
    return torch.exp(2j * np.pi * t * m / N) \
        / torch.sqrt(torch.tensor(N, dtype=torch.float32))


def prach_time_generate(xf, n_fft: int, fmt: int, n_ra_prb: int,
                        n_rb_ul: int):
    """Frequency-domain preambles [B, n_zc] -> time-domain PRACH bursts
    [B, T_CP + reps T_SEQ] at fs = n_fft 15 kHz: the big IDFT, the
    repetitions, the cyclic prefix."""
    E = device_plan(_phasor(n_fft, fmt, n_ra_prb, n_rb_ul, xf.shape[-1]),
                    xf.device)
    s = xf @ E.T                                   # [B, N] one period
    _, _, reps = FORMAT_TIMING[fmt]
    body = torch.cat([s] * reps, dim=-1)
    ncp = prach_cp_samples(n_fft, fmt)
    if ncp <= body.shape[-1]:
        cp = body[:, -ncp:]
    else:
        cp = body.repeat(1, -(-ncp // body.shape[-1]))[:, -ncp:]
    return torch.cat([cp, body], dim=-1)


def prach_time_to_bins(rx, n_fft: int, fmt: int, n_ra_prb: int,
                       n_rb_ul: int, n_zc: int = N_ZC):
    """Received samples [B, >= T_CP + reps T_SEQ] -> [B, n_zc] PRACH bins:
    skip the CP, average the repetitions (formats 2/3, +3 dB), the big
    DFT restricted to the PRACH region."""
    N = prach_samples_per_seq(n_fft, fmt)
    ncp = prach_cp_samples(n_fft, fmt)
    _, _, reps = FORMAT_TIMING[fmt]
    body = rx[:, ncp:ncp + reps * N].reshape(rx.shape[0], reps, N).mean(dim=1)
    E = device_plan(_phasor(n_fft, fmt, n_ra_prb, n_rb_ul, n_zc), rx.device)
    # body @ conj(E), without a conjugated copy of E
    return (body.conj() @ E).conj().resolve_conj()  # [B, n_zc]


def prach_time_detect(rx, n_fft: int, fmt: int, n_ra_prb: int,
                      n_rb_ul: int, u: int, ncs: int,
                      threshold: float = 15.0, n_zc: int = N_ZC,
                      shifts: list[int] | None = None):
    """Sample-stream detection: time -> bins -> correlator. The delay is
    in ZC samples; one ZC sample is N / n_zc time samples."""
    bins = prach_time_to_bins(rx, n_fft, fmt, n_ra_prb, n_rb_ul, n_zc)
    return prach_detect(bins, u, ncs, threshold, n_zc, shifts)
