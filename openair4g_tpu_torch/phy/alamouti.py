"""Transmit diversity: SFBC (Alamouti) precoding and combining, TM2
(counterpart of openair4g_tpu/phy/alamouti.py), 36.211 §6.3.4.3.

Symbol pair (x0, x1) on frequency-adjacent REs (k, k+1):
    port0: [ x0,   x1 ] / sqrt(2)
    port1: [-x1*,  x0*] / sqrt(2)
Receiver, per RX antenna r (the pair's channel taken from RE k):
    x0_hat = h0r* y_k     + h1r y_{k+1}*
    x1_hat = h0r* y_{k+1} - h1r y_k*
so x_hat = (|h0r|^2 + |h1r|^2)/sqrt(2) x + noise; MRC adds over r.
"""
from __future__ import annotations

import torch

_INV_SQRT2 = 0.7071067811865476


def sfbc_encode(x):
    """x [B, N] (N even) -> (port0 [B, N], port1 [B, N]); pairs are
    (x[2i], x[2i+1]) on consecutive data REs."""
    x0 = x[..., 0::2]
    x1 = x[..., 1::2]
    p0 = torch.stack([x0, x1], dim=-1).reshape(x.shape)
    p1 = torch.stack([-x1.conj(), x0.conj()], dim=-1).reshape(x.shape)
    return p0 * _INV_SQRT2, p1 * _INV_SQRT2


def sfbc_combine(y, h0, h1, n0):
    """Alamouti combine + MRC over RX antennas.

    y, h0, h1: [B, R, N] (h_p: channel of TX port p). Returns (x_hat [B, N]
    unit-gain symbol estimates, n0_eff [B, N] post-combining noise variance,
    repeated over each pair so it has x_hat's full shape)."""
    yk = y[..., 0::2]
    yk1 = y[..., 1::2]
    h0k = h0[..., 0::2]
    h1k = h1[..., 0::2]          # pair assumed flat: the even RE's channel
    x0 = (h0k.conj() * yk + h1k * yk1.conj()).sum(dim=1)
    x1 = (h0k.conj() * yk1 - h1k * yk.conj()).sum(dim=1)
    g_sum = (h0k.abs() ** 2 + h1k.abs() ** 2).sum(dim=1) + 1e-12  # [B, N/2]
    scale = 1.0 / (g_sum * _INV_SQRT2)
    x_hat = torch.stack([x0 * scale, x1 * scale], dim=-1)
    x_hat = x_hat.reshape(x_hat.shape[0], -1)
    n0_eff = (2.0 * n0 / g_sum).repeat_interleave(2, dim=-1)
    return x_hat, n0_eff
