"""The windowed max-log-MAP half-iteration in plain PyTorch: a frozen copy
of the port's plain version (half_iteration_ref), which its kernels equal
bit for bit. Each window of W trellis positions warms its alpha and beta
up over U positions of its neighbours."""
from __future__ import annotations

import torch

from ..device import device_plan

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
        device_plan(t, dev) for t in _TABLES)
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
