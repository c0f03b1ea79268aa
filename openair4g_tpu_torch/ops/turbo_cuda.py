"""Turbo half-iteration on the card: wrappers of csrc/turbo_half_iter.cu and
their plain PyTorch versions.

Replaces both TPU kernels of openair4g_tpu/ops/turbo_pallas.py. The v2
kernel (`half_iteration_pallas_v2`, the decoder's) is `half_iteration`: a
windowed max-log-MAP with U-step alpha and beta warm-ups per window. That
is not the XLA oracle `turbo._half_iteration`, whose beta at a window's
last node is the neighbouring window's converged beta, so the two differ
at window-end nodes (by about 1 on random inputs). The v1 kernel
(`prep_parity` + `half_iteration_pallas_prepped`) is `prep_parity` +
`half_iteration_prepped`: the same half-iteration from window-replicated
t-major frames, which differs from v2 only in rounding at window ends.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..device import count_launch

NEG = -1e9
BIG = 1e4


def _trellis_tables():
    s = list(range(8))
    next0 = [((((x >> 1) ^ x) & 1) << 2) | (x >> 1) for x in s]
    next1 = [(((((x >> 1) ^ x) ^ 1) & 1) << 2) | (x >> 1) for x in s]
    pred0 = [2 * (x & 3) for x in s]
    pred1 = [2 * (x & 3) + 1 for x in s]
    sz0 = [1.0 - 2.0 * (((x >> 2) ^ (x >> 1)) & 1) for x in s]   # PARITY[:,0]
    su_p = [1.0 - 2.0 * (((x >> 2) ^ x) & 1) for x in s]
    sz_p = [1.0 - 2.0 * (((x >> 2) ^ (x >> 1)) & 1) for x in s]
    return next0, next1, pred0, pred1, sz0, su_p, sz_p


_TABLES = _trellis_tables()


def pick_unroll(W: int, U: int) -> int:
    """Renormalization period R of the sweeps (the TPU kernel's unroll)."""
    for r in (8, 4, 2):
        if (W + U) % r == 0 and U % r == 0:
            return r
    return 1


def _check_args(lin, lp, W: int, U: int):
    if lin.dim() != 2 or lin.shape != lp.shape:
        raise ValueError(f"lin {tuple(lin.shape)} and lp {tuple(lp.shape)} "
                         "must be the same [B, N]")
    if lin.shape[1] % W or not 0 < U <= W:
        raise ValueError(f"N={lin.shape[1]} must be a multiple of W={W}, "
                         f"and 0 < U={U} <= W")


def half_iteration_ref(lin, lp, W: int, U: int):
    """Plain PyTorch version. lin, lp: [B, N] float32 systematic(+a-priori)
    and parity LLRs, N a multiple of W (padded with +BIG past the trellis
    end). Returns the APP LLR [B, N]."""
    _check_args(lin, lp, W, U)
    B, N = lin.shape
    n_w = N // W
    L = B * n_w
    R = pick_unroll(W, U)
    dev = lin.device
    lane_w = torch.arange(L, device=dev) % n_w
    win0 = lane_w == 0
    winlast = lane_w == n_w - 1

    def frames(g):
        gm = g.reshape(B, n_w, W).permute(2, 0, 1).reshape(W, L)
        gw = torch.where(win0, 0.0, torch.roll(gm[W - U:], 1, dims=1))
        gt = torch.where(winlast, BIG, torch.roll(gm[:U], -1, dims=1))
        return gm, gw, gt

    gum, guw, gut = frames(0.5 * lin)
    gpm, gpw, gpt = frames(0.5 * lp)
    n0, n1, p0, p1, sz0, su_p, sz_p = (
        torch.tensor(t, device=dev) for t in _TABLES)
    sz0, su_p, sz_p = (x.float()[:, None] for x in (sz0, su_p, sz_p))

    def norm(x):
        return x - x.max(dim=0, keepdim=True).values

    def bstep(beta, gu, gp):
        gp_term = sz0 * gp[None]
        return torch.maximum(beta[n0] + gu[None] + gp_term,
                             beta[n1] - gu[None] - gp_term)

    def astep(alpha, gu, gp):
        base = su_p * gu[None] + sz_p * gp[None]
        return torch.maximum(alpha[p0] + base, alpha[p1] - base)

    beta = torch.zeros(8, L, device=dev)
    for i in range(U // R):
        for r in range(R):
            t = U - 1 - (i * R + r)
            beta = bstep(beta, gut[t], gpt[t])
        beta = norm(beta)
    betas = [None] * (W + 1)
    betas[W] = beta
    for i in range(W // R):
        for r in range(R):
            t = W - 1 - (i * R + r)
            beta = bstep(beta, gum[t], gpm[t])
            betas[t] = beta
        beta = norm(beta)

    alpha = torch.zeros(8, L, device=dev)
    for i in range(U // R):
        for r in range(R):
            t = i * R + r
            alpha = astep(alpha, guw[t], gpw[t])
        alpha = norm(alpha)
    exact0 = torch.full((8, 1), NEG, device=dev)
    exact0[0] = 0.0
    alpha = torch.where(win0[None], exact0, alpha)

    out = torch.empty(W, L, device=dev)
    for i in range(W // R):
        for r in range(R):
            tau = i * R + r
            gu_n = gum[tau]
            gp_term = sz0 * gpm[tau][None]
            bn = betas[tau + 1]
            m0 = (alpha + gp_term + bn[n0]).max(dim=0).values
            m1 = (alpha - gp_term + bn[n1]).max(dim=0).values
            out[tau] = (m0 + gu_n) - (m1 - gu_n)
            alpha = astep(alpha, gum[tau], gpm[tau])
        alpha = norm(alpha)
    return out.reshape(W, B, n_w).permute(1, 2, 0).reshape(B, N)


def half_iteration(lin, lp, W: int, U: int):
    """One half-iteration: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if lin.device.type == "cpu" and lp.device.type == "cpu":
        return half_iteration_ref(lin, lp, W, U)
    if lin.device.type != "cuda" or lp.device != lin.device:
        raise ValueError(f"half_iteration: lin on {lin.device}, lp on "
                         f"{lp.device}; both must be on one CUDA device")
    _check_args(lin, lp, W, U)
    if lin.dtype != torch.float32 or lp.dtype != torch.float32:
        raise TypeError("half_iteration: float32 inputs required")
    if not (lin.is_contiguous() and lp.is_contiguous()):
        raise ValueError("half_iteration: contiguous inputs required")
    B, N = lin.shape
    n_w = N // W
    L = B * n_w
    lib = kernels.load()
    out = torch.empty_like(lin)
    scr = torch.empty((W + 1) * 8 * L, dtype=torch.float32, device=lin.device)
    stream = torch.cuda.current_stream(lin.device).cuda_stream
    err = lib.turbo_half_iter_launch(lin.data_ptr(), lp.data_ptr(),
                                     out.data_ptr(), scr.data_ptr(), B, n_w,
                                     W, U, pick_unroll(W, U), stream)
    kernels.check(err, "turbo_half_iter")
    count_launch("turbo_half_iter")
    return out


# ------------------------------------------------------------------ v1 --

def _frames(g, W: int, U: int, pad_val: float):
    """[B, N] gammas -> t-major (fwd, bwd) frames [W+U, B*n_w]: fwd row t of
    window w is position w*W - U + t (0 before the start), bwd row t is
    position w*W + t (pad_val past the end); lane = b*n_w + w."""
    B, N = g.shape
    n_w = N // W
    main = g.reshape(B, n_w, W)
    head = torch.cat([g.new_zeros(B, U), g[:, :N - U]], dim=1)
    warm = head.reshape(B, n_w, W)[:, :, :U]
    tail = torch.cat([g[:, W:], g.new_full((B, W), pad_val)], dim=1)
    tail = tail.reshape(B, n_w, W)[:, :, :U]
    fwd = torch.cat([warm, main], dim=2)
    bwd = torch.cat([main, tail], dim=2)
    return tuple(f.permute(2, 0, 1).reshape(W + U, B * n_w).contiguous()
                 for f in (fwd, bwd))


def prep_parity(lp, W: int, U: int):
    """Parity frames (gpf, gpb) [W+U, B*n_w] of lp [B, N], built once per
    decode since the parity LLRs do not change across iterations."""
    _check_args(lp, lp, W, U)
    return _frames(0.5 * lp, W, U, BIG)


def _check_prepped(lin, gpf, gpb, W: int, U: int):
    _check_args(lin, lin, W, U)
    shape = (W + U, lin.shape[0] * (lin.shape[1] // W))
    if tuple(gpf.shape) != shape or tuple(gpb.shape) != shape:
        raise ValueError(f"gpf {tuple(gpf.shape)}, gpb {tuple(gpb.shape)}: "
                         f"prep_parity frames {shape} expected")


def _unframe(out, B: int, n_w: int, W: int):
    return out.reshape(W, B, n_w).permute(1, 2, 0).reshape(B, n_w * W)


def half_iteration_prepped_ref(lin, gpf, gpb, W: int, U: int):
    """Plain PyTorch version of the v1 kernel: lin [B, N] float32, parity
    frames from prep_parity. Returns the APP LLR [B, N]."""
    _check_prepped(lin, gpf, gpb, W, U)
    B, N = lin.shape
    n_w = N // W
    T = W + U
    R = pick_unroll(W, U)
    dev = lin.device
    guf, gub = _frames(0.5 * lin, W, U, BIG)
    win0 = torch.arange(B * n_w, device=dev) % n_w == 0
    n0, n1, p0, p1, sz0, su_p, sz_p = (
        torch.tensor(t, device=dev) for t in _TABLES)
    sz0, su_p, sz_p = (x.float()[:, None] for x in (sz0, su_p, sz_p))

    def norm(x):
        return x - x.max(dim=0, keepdim=True).values

    def astep(alpha, gu, gp):
        base = su_p * gu[None] + sz_p * gp[None]
        return torch.maximum(alpha[p0] + base, alpha[p1] - base)

    beta = torch.zeros(8, B * n_w, device=dev)
    betas = [None] * T
    for i in range(T // R):
        for r in range(R):
            t = T - 1 - (i * R + r)
            gp_term = sz0 * gpb[t][None]
            beta = torch.maximum(beta[n0] + gub[t][None] + gp_term,
                                 beta[n1] - gub[t][None] - gp_term)
            betas[t] = beta
        beta = norm(beta)

    alpha = torch.zeros(8, B * n_w, device=dev)
    for i in range(U // R):
        for r in range(R):
            alpha = astep(alpha, guf[i * R + r], gpf[i * R + r])
        alpha = norm(alpha)
    exact0 = torch.full((8, 1), NEG, device=dev)
    exact0[0] = 0.0
    alpha = torch.where(win0[None], exact0, alpha)

    out = torch.empty(W, B * n_w, device=dev)
    for i in range(W // R):
        for r in range(R):
            tau = i * R + r
            gp_term = sz0 * gpb[tau][None]
            bn = betas[tau + 1]
            m0 = (alpha + gp_term + bn[n0]).max(dim=0).values
            m1 = (alpha - gp_term + bn[n1]).max(dim=0).values
            out[tau] = (m0 + gub[tau]) - (m1 - gub[tau])
            alpha = astep(alpha, guf[U + tau], gpf[U + tau])
        alpha = norm(alpha)
    return _unframe(out, B, n_w, W)


def half_iteration_prepped(lin, gpf, gpb, W: int, U: int):
    """One v1 half-iteration on pre-framed parity: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    args = (lin, gpf, gpb)
    if all(a.device.type == "cpu" for a in args):
        return half_iteration_prepped_ref(lin, gpf, gpb, W, U)
    if lin.device.type != "cuda" or any(a.device != lin.device for a in args):
        raise ValueError("half_iteration_prepped: lin, gpf and gpb must be "
                         "on one CUDA device")
    _check_prepped(lin, gpf, gpb, W, U)
    if any(a.dtype != torch.float32 for a in args):
        raise TypeError("half_iteration_prepped: float32 inputs required")
    if not (gpf.is_contiguous() and gpb.is_contiguous()):
        raise ValueError("half_iteration_prepped: contiguous frames required")
    B, N = lin.shape
    n_w = N // W
    L = B * n_w
    guf, gub = _frames(0.5 * lin, W, U, BIG)
    lib = kernels.load()
    out = torch.empty(W, L, dtype=torch.float32, device=lin.device)
    scr = torch.empty((W + U) * 8 * L, dtype=torch.float32, device=lin.device)
    stream = torch.cuda.current_stream(lin.device).cuda_stream
    err = lib.turbo_half_iter_v1_launch(
        guf.data_ptr(), gpf.data_ptr(), gub.data_ptr(), gpb.data_ptr(),
        out.data_ptr(), scr.data_ptr(), L, n_w, W, U, pick_unroll(W, U),
        stream)
    kernels.check(err, "turbo_half_iter_v1")
    count_launch("turbo_half_iter_v1")
    return _unframe(out, B, n_w, W)
