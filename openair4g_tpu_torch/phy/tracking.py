"""Timing tracking, AGC, and pilot-based frequency tracking (counterpart
of openair4g_tpu/phy/tracking.py): small reductions over channel
estimates the receiver already has, batched over trials.
"""
from __future__ import annotations

import math

import torch


def timing_gate(H_freq, cp_len: int, n_fft: int):
    """Early/late timing gate from a frequency-domain channel estimate
    H_freq [B, M] over M contiguous subcarriers. Returns (offset_samples
    [B]: the delay-domain energy centroid, positive when the impulse
    response arrives late; gate [B]: the sign of late minus early energy
    in windows of half the CP)."""
    g = torch.fft.ifft(H_freq, dim=-1)
    M = H_freq.shape[-1]
    p = g.abs() ** 2
    w = max(1, int(round(cp_len * M / n_fft / 2)))
    early = torch.sum(p[..., :w], dim=-1)
    late = torch.sum(p[..., M - w:], dim=-1)     # negative delays
    k = torch.cat([torch.arange(0, M // 2, device=p.device),
                   torch.arange(-M // 2, 0, device=p.device)])
    cent = torch.sum(p * k, dim=-1) / torch.clamp(torch.sum(p, dim=-1),
                                                  min=1e-12)
    return cent * n_fft / M, torch.sign(late - early)


def track_timing(rx_offset, offset_est, step: int = 1, deadzone: float = 0.5):
    """One tracking update: move rx_offset by +-step when the estimated
    offset leaves the deadzone."""
    adj = torch.where(offset_est > deadzone, step,
                      torch.where(offset_est < -deadzone, -step, 0))
    return rx_offset + adj


def agc_gain(rssi_per_sc, target: float = 1.0):
    """Linear gain g with g^2 RSSI = target."""
    return torch.sqrt(target / torch.clamp(rssi_per_sc, min=1e-12))


def pilot_cfo_estimate(h_p0, h_p1, symbol_distance: int, n_fft: int,
                       cp: int):
    """Residual CFO in subcarrier spacings from channel estimates h_p0,
    h_p1 [B, M] at two pilot symbols `symbol_distance` OFDM symbols apart:
    the phase of their cross-correlation."""
    x = torch.sum(h_p1 * torch.conj(h_p0), dim=-1)
    dt = symbol_distance * (n_fft + cp)          # samples between pilots
    return torch.angle(x) / (2.0 * math.pi) * n_fft / dt
