"""Multi-layer detection (counterpart of openair4g_tpu/phy/mimo_rx.py): the
per-RE 2x2 MMSE equalizer in closed form, and exact max-log LLRs of one
layer with a constellation-constrained interfering layer (the reference's
interference-aware dual-stream receivers), as a max over the joint
constellation table."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import device_plan
from ..tables.modulation import mod_table

_EPS = 1e-12


def mmse_detect(y, He, n0):
    """Per-RE unbiased MMSE for L = 2 layers, any R >= 2.

    y [B, N, R], He [B, N, R, 2], n0 scalar noise variance. Returns
    (x_hat [B, N, 2] unit-gain symbol estimates, n0_eff [B, N, 2] effective
    noise variance after equalization, residual inter-layer interference
    included)."""
    h0 = He[..., 0]
    h1 = He[..., 1]
    a = (h0.abs() ** 2).sum(-1) + n0                 # [B, N]
    d = (h1.abs() ** 2).sum(-1) + n0
    b = (h0.conj() * h1).sum(-1)
    det = a * d - b.abs() ** 2 + _EPS
    z0 = (h0.conj() * y).sum(-1)                     # matched filter outputs
    z1 = (h1.conj() * y).sum(-1)
    x0 = (d * z0 - b * z1) / det
    x1 = (a * z1 - b.conj() * z0) / det
    # bias mu_l = [G He]_ll; unbiased estimate x_l / mu_l, SINR mu/(1 - mu)
    g00 = (d * (a - n0) - b.abs() ** 2) / det
    g11 = (a * (d - n0) - b.abs() ** 2) / det
    mu0 = g00.clamp(_EPS, 1.0 - 1e-6)
    mu1 = g11.clamp(_EPS, 1.0 - 1e-6)
    x_hat = torch.stack([x0 / mu0, x1 / mu1], dim=-1)
    n0_eff = torch.stack([(1.0 - mu0) / mu0, (1.0 - mu1) / mu1], dim=-1)
    return x_hat, n0_eff


@functools.lru_cache(maxsize=None)
def _joint_tables(qm0: int, qm1: int):
    """Joint constellation tables (s0 [J], s1 [J]) and layer 0's bits
    bit0 [qm0, J], J = 2^qm0 * 2^qm1."""
    t0 = mod_table(qm0)
    t1 = mod_table(qm1)
    i0 = np.repeat(np.arange(1 << qm0), 1 << qm1)
    i1 = np.tile(np.arange(1 << qm1), 1 << qm0)
    bit0 = ((i0[None, :] >> (qm0 - 1 - np.arange(qm0)[:, None])) & 1
            ).astype(np.int8)
    return t0[i0].astype(np.complex64), t1[i1].astype(np.complex64), bit0


def _is_zero(bits: np.ndarray) -> np.ndarray:
    return bits == 0


def dual_stream_llr(z0, rho, g0, n0, qm0: int, qm1: int, chunk: int = 512):
    """Exact max-log LLRs of layer 0 with layer 1 a constellation-constrained
    interferer. Model after matched filtering with h0:
    z0 = g0 s0 + rho s1 + w, w ~ CN(0, g0 n0), g0 = |h0|^2, rho = h0^H h1.

    z0, rho, g0: [B, N] (complex, complex, real). Returns [B, N, qm0].
    Chunked over N so the [B, chunk, J] joint metric stays bounded."""
    s0, s1, bit0 = _joint_tables(qm0, qm1)
    dev = z0.device
    s0, s1 = device_plan(s0, dev), device_plan(s1, dev)
    mask0 = device_plan(bit0, dev, _is_zero)               # [qm0, J]
    neg_inf = torch.full((), -float("inf"), device=dev)
    outs = []
    for start in range(0, z0.shape[1], chunk):
        z = z0[:, start:start + chunk]
        r = rho[:, start:start + chunk]
        g = g0[:, start:start + chunk]
        mean = g[..., None] * s0 + r[..., None] * s1        # [B, n, J]
        d2 = (z[..., None] - mean).abs() ** 2
        metric = -d2 / (g.clamp_min(_EPS) * n0)[..., None]
        m0 = torch.where(mask0[:, None, None, :], metric[None],
                         neg_inf).amax(dim=-1)
        m1 = torch.where(~mask0[:, None, None, :], metric[None],
                         neg_inf).amax(dim=-1)
        outs.append((m0 - m1).movedim(0, -1))               # [B, n, qm0]
    return torch.cat(outs, dim=1)


def mf_dual_stream(y, He):
    """Matched-filter front end for dual_stream_llr: y [B, N, R],
    He [B, N, R, 2] -> per layer l, (z_l = h_l^H y, g_l = |h_l|^2,
    rho_l = h_l^H h_other), each [B, N]."""
    h0 = He[..., 0]
    h1 = He[..., 1]
    z0 = (h0.conj() * y).sum(-1)
    z1 = (h1.conj() * y).sum(-1)
    g0 = (h0.abs() ** 2).sum(-1)
    g1 = (h1.abs() ** 2).sum(-1)
    rho01 = (h0.conj() * h1).sum(-1)
    return (z0, g0, rho01), (z1, g1, rho01.conj())
