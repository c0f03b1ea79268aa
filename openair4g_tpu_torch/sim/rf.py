"""RF impairment models: IQ imbalance, phase noise, DAC/ADC quantization,
carrier frequency offset (counterpart of openair4g_tpu/sim/rf.py).
Elementwise maps over the time-domain waveform, batched over trials;
`phase_noise` takes its normals injected.
"""
from __future__ import annotations

import numpy as np
import torch


def iq_imbalance(t, iqim: float):
    """dlsim's model: the Q rail picks up iqim times the I rail."""
    return torch.complex(t.real, t.imag + iqim * t.real)


def iq_imbalance_full(t, amp_db: float = 0.0, phase_deg: float = 0.0):
    """General TX IQ imbalance: y = a x + b conj(x) with
    a = (1 + g e^{j phi}) / 2, b = (1 - g e^{j phi}) / 2."""
    g = 10.0 ** (amp_db / 20.0)
    phi = np.deg2rad(phase_deg)
    a = complex(0.5 * (1.0 + g * np.exp(1j * phi)))
    b = complex(0.5 * (1.0 - g * np.exp(1j * phi)))
    return a * t + b * torch.conj(t)


def phase_noise(normals, t, linewidth_hz: float, sample_rate_hz: float):
    """Wiener phase noise: a random-walk phase of per-sample variance
    2 pi linewidth / fs (a free-running oscillator). normals [B, L]
    standard normals, one a sample of t [B, L]."""
    var = 2.0 * np.pi * linewidth_hz / sample_rate_hz
    steps = normals.to(t.device, torch.float32) \
        * float(np.sqrt(np.float32(var)))
    return t * torch.exp(1j * torch.cumsum(steps, dim=-1))


def dac(t, n_bits: int = 12, full_scale: float = 4.0):
    """Quantize I/Q to n_bits over [-full_scale, +full_scale]."""
    q = full_scale / (1 << (n_bits - 1))

    def _q(x):
        return torch.clamp(torch.round(x / q), -(1 << (n_bits - 1)),
                           (1 << (n_bits - 1)) - 1) * q
    return torch.complex(_q(t.real), _q(t.imag))


adc = dac   # the same model on the receive side


def cfo(t, cfo_scs: float, n_fft: int):
    """Carrier frequency offset of `cfo_scs` subcarrier spacings."""
    L = t.shape[-1]
    return t * torch.exp(2j * np.pi * cfo_scs / n_fft
                         * torch.arange(L, device=t.device))
