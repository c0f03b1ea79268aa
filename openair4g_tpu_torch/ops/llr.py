"""QAM mapping and max-log LLR demapping, 3GPP TS 36.211 §7.1.

Counterpart of openair4g_tpu/ops/llr.py. Convention: LLR = log P(0)/P(1)
(positive <=> bit 0), bits MSB-first per symbol (b0 = I sign, b1 = Q sign).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import device_plan
from ..tables.modulation import mod_table


def map_symbols(bits, Qm: int):
    """bits [B, E] {0,1} int -> complex64 symbols [B, E/Qm] (closed-form
    Gray/PAM arithmetic, bit-exact with the constellation tables)."""
    B, E = bits.shape
    if E % Qm:
        raise ValueError(f"E={E} is not a multiple of Qm={Qm}")
    b = bits.reshape(B, E // Qm, Qm).to(torch.float32)
    s = 1.0 - 2.0 * b
    if Qm == 2:
        amp_i = amp_q = 1.0
        norm = np.sqrt(2.0)
    elif Qm == 4:
        amp_i = 2.0 - s[..., 2]
        amp_q = 2.0 - s[..., 3]
        norm = np.sqrt(10.0)
    elif Qm == 6:
        amp_i = 4.0 - s[..., 2] * (2.0 - s[..., 4])
        amp_q = 4.0 - s[..., 3] * (2.0 - s[..., 5])
        norm = np.sqrt(42.0)
    else:
        raise ValueError(f"Qm={Qm}")
    re = s[..., 0] * amp_i / norm
    im = s[..., 1] * amp_q / norm
    return torch.complex(re, im)


@functools.lru_cache(maxsize=None)
def _pam_levels(Qm: int):
    """Per-axis PAM levels [L] and, per bit of the axis, the level subsets
    bit_of_level [Qm//2, L] in {0,1}. Axis bit 0 is the sign bit."""
    table = mod_table(Qm)
    levels = []
    bit_patterns = []
    for idx in range(1 << Qm):
        bits = [(idx >> (Qm - 1 - k)) & 1 for k in range(Qm)]
        if all(bits[k] == 0 for k in range(1, Qm, 2)):
            levels.append(table[idx].real)
            bit_patterns.append([bits[k] for k in range(0, Qm, 2)])
    return (np.asarray(levels, np.float32),
            np.asarray(bit_patterns, np.int8).T)


def as_f32(x, device) -> torch.Tensor:
    """x (a tensor, array or number) as float32 on `device`; a number is
    filled on the device, with no host-to-device copy."""
    if torch.is_tensor(x):
        return x.to(device, torch.float32)
    if np.ndim(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _is_zero(bits: np.ndarray) -> np.ndarray:
    return bits == 0


def demap_llr(y, N0, Qm: int):
    """Exact max-log LLRs. y [...] complex equalized symbols, N0 scalar or
    broadcastable to y.shape. Returns [..., Qm] float32, bit order
    b0..b{Qm-1}."""
    levels, bit_of_level = _pam_levels(Qm)
    lv = device_plan(levels, y.device)
    zero = device_plan(bit_of_level, y.device, _is_zero)      # [nb, L]
    nb = Qm // 2
    N0t = as_f32(N0, y.device)
    inv_n0 = 1.0 / (N0t[..., None] if N0t.dim() else N0t)
    out = []
    for axis_val in (y.real, y.imag):
        metric = -((axis_val[..., None] - lv) ** 2) * inv_n0      # [..., L]
        axis_llrs = []
        for b in range(nb):
            mask0 = zero[b]
            m0 = metric[..., mask0].max(dim=-1).values
            m1 = metric[..., ~mask0].max(dim=-1).values
            axis_llrs.append(m0 - m1)
        out.append(axis_llrs)
    ordered = []
    for b in range(nb):
        ordered.append(out[0][b])
        ordered.append(out[1][b])
    return torch.stack(ordered, dim=-1)
