"""Turbo half-iteration on the card: wrappers of csrc/turbo_half_iter.cu and
their plain PyTorch versions.

Replaces both TPU kernels of openair4g_tpu/ops/turbo_pallas.py. The v2
kernel (`half_iteration_pallas_v2`, the decoder's) is `half_iteration`: a
windowed max-log-MAP with U-step alpha and beta warm-ups per window. That
is not the XLA oracle `turbo._half_iteration`, whose beta at a window's
last node is the neighbouring window's converged beta, so the two differ
at window-end nodes (by about 1 on random inputs). The v1 kernel
(`prep_parity` + `half_iteration_pallas_prepped`) is `prep_parity` +
`half_iteration_prepped`: the same half-iteration with the parity given as
window-replicated t-major frames, built once a decode; it differs from v2
only in rounding at window ends. Both kernels keep one beta checkpoint per
renormalization block in a scratch the wrapper allocates and read lin
[B, N] where it lies: a call is one launch.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..device import count_launch, device_plan

NEG = -1e9
BIG = 1e4
# Float32 operations a trellis position of one half-iteration takes: beta
# step 40, alpha step 32, LLR 51 (8 states), renormalizations and the two
# 0.5 scalings 5.
TURBO_OPS_PER_POS = 128


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


def scratch_numel(L: int, W: int, U: int) -> int:
    """Floats of either kernel's scratch for L lanes: one beta checkpoint
    (8 metrics) per lane and renormalization block, [W / R, L, 8]."""
    return W // pick_unroll(W, U) * L * 8


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


def _ckpt_sweeps(gu, gp, hu, hp, tu, tp, n_w: int, R: int, v1: bool):
    """The kernels' order of work in plain PyTorch on lane-major rows: gu,
    gp [L, W] each window's gammas, hu, hp [L, U] the next window's head,
    tu, tp [L, U] the previous window's tail. The backward sweep keeps one
    beta checkpoint per R nodes (beta at node p before its block's
    renormalization; at node W the warm-up's carried state in v2, the value
    before that renormalization in v1) and skips its last block; each
    forward block recomputes its R betas from its checkpoint ahead of its
    LLRs and alpha steps. Returns the LLRs [L, W]."""
    L, W = gu.shape
    U = hu.shape[1]
    nb = W // R
    dev = gu.device
    n0, n1, p0, p1, sz0, su_p, sz_p = (device_plan(t, dev) for t in _TABLES)
    sz0, su_p, sz_p = (x.float() for x in (sz0, su_p, sz_p))
    w = torch.arange(L, device=dev)[:, None] % n_w

    def norm(x):
        return x - x.max(dim=1, keepdim=True).values

    def bstep(b, gu_t, gp_t):
        gpt = sz0 * gp_t[:, None]
        return torch.maximum(b[:, n0] + gu_t[:, None] + gpt,
                             b[:, n1] - gu_t[:, None] - gpt)

    def astep(a, gu_t, gp_t):
        base = su_p * gu_t[:, None] + sz_p * gp_t[:, None]
        return torch.maximum(a[:, p0] + base, a[:, p1] - base)

    beta = torch.zeros(L, 8, device=dev)
    for i in range(U // R):
        for t in range(U - 1 - i * R, U - 1 - (i + 1) * R, -1):
            beta = bstep(beta, hu[:, t], hp[:, t])
        before = beta
        beta = norm(beta)
    ckpt = [None] * nb                        # ckpt[k]: beta at node (k+1) R
    ckpt[nb - 1] = before if v1 else beta
    for lo in range(W - R, 0, -R):
        for t in range(lo + R - 1, lo - 1, -1):
            beta = bstep(beta, gu[:, t], gp[:, t])
        ckpt[lo // R - 1] = beta
        beta = norm(beta)

    alpha = torch.zeros(L, 8, device=dev)
    for i in range(U // R):
        for t in range(i * R, (i + 1) * R):
            alpha = astep(alpha, tu[:, t], tp[:, t])
        alpha = norm(alpha)
    exact0 = torch.full((8,), NEG, device=dev)
    exact0[0] = 0.0
    alpha = torch.where(w == 0, exact0, alpha)

    out = torch.empty(L, W, device=dev)
    for j in range(nb):
        b = ckpt[j] if j == nb - 1 and not v1 else norm(ckpt[j])
        bv = [None] * R                       # bv[r]: beta at node jR + r + 1
        bv[R - 1] = ckpt[j]
        for r in range(R - 2, -1, -1):
            b = bv[r] = bstep(b, gu[:, j * R + r + 1], gp[:, j * R + r + 1])
        for r in range(R):
            tau = j * R + r
            gpt = sz0 * gp[:, tau][:, None]
            m0 = (alpha + gpt + bv[r][:, n0]).max(dim=1).values
            m1 = (alpha - gpt + bv[r][:, n1]).max(dim=1).values
            out[:, tau] = (m0 + gu[:, tau]) - (m1 - gu[:, tau])
            alpha = astep(alpha, gu[:, tau], gp[:, tau])
        alpha = norm(alpha)
    return out


def _head(g, n_w: int, U: int):
    """[L, W] lane-major rows -> the next window's first U nodes (BIG at a
    block's last window)."""
    w = torch.arange(g.shape[0], device=g.device)[:, None] % n_w
    return torch.where(w == n_w - 1, BIG, torch.roll(g[:, :U], -1, 0))


def _tail(g, n_w: int, U: int):
    """[L, W] lane-major rows -> the previous window's last U nodes (0 at a
    block's first window)."""
    w = torch.arange(g.shape[0], device=g.device)[:, None] % n_w
    return torch.where(w == 0, 0.0, torch.roll(g[:, g.shape[1] - U:], 1, 0))


def _half_iteration_ckpt_ref(lin, lp, W: int, U: int):
    """The v2 kernel's order of work in plain PyTorch, for the tests. Equal
    to half_iteration_ref bit for bit."""
    _check_args(lin, lp, W, U)
    B, N = lin.shape
    n_w = N // W
    gu, gp = (0.5 * g.reshape(B * n_w, W) for g in (lin, lp))
    out = _ckpt_sweeps(gu, gp, _head(gu, n_w, U), _head(gp, n_w, U),
                       _tail(gu, n_w, U), _tail(gp, n_w, U), n_w,
                       pick_unroll(W, U), v1=False)
    return out.reshape(B, N)


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
    lib = kernels.load()
    out = torch.empty_like(lin)
    for name, t in (("lin", lin), ("lp", lp), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"half_iteration: {name} is not 16-byte aligned"
                             " (the kernel loads float4 vectors)")
    scr = torch.empty(scratch_numel(B * n_w, W, U), dtype=torch.float32,
                      device=lin.device)
    err = lib.turbo_half_iter_launch(lin.data_ptr(), lp.data_ptr(),
                                     out.data_ptr(), scr.data_ptr(), B, n_w,
                                     W, U, pick_unroll(W, U),
                                     kernels.stream_of(lin))
    kernels.check(err, "turbo_half_iter")
    count_launch("turbo_half_iter", (B, N, W, U))
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
        device_plan(t, dev) for t in _TABLES)
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


def _half_iteration_prepped_ckpt_ref(lin, gpf, gpb, W: int, U: int):
    """The v1 kernel's order of work in plain PyTorch, for the tests: lin
    read in place (its head and tail from the neighbouring windows' rows),
    the parity from the frames, a main position's from gpb only. Equal to
    half_iteration_prepped_ref bit for bit."""
    _check_prepped(lin, gpf, gpb, W, U)
    B, N = lin.shape
    n_w = N // W
    gu = 0.5 * lin.reshape(B * n_w, W)
    out = _ckpt_sweeps(gu, gpb[:W].t(), _head(gu, n_w, U), gpb[W:].t(),
                       _tail(gu, n_w, U), gpf[:U].t(), n_w,
                       pick_unroll(W, U), v1=True)
    return out.reshape(B, N)


def half_iteration_prepped(lin, gpf, gpb, W: int, U: int):
    """One v1 half-iteration on pre-framed parity: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. gpf and gpb must be what
    prep_parity gives (the kernel reads a main position's parity from gpb
    alone)."""
    args = (lin, gpf, gpb)
    if all(a.device.type == "cpu" for a in args):
        return half_iteration_prepped_ref(lin, gpf, gpb, W, U)
    if lin.device.type != "cuda" or any(a.device != lin.device for a in args):
        raise ValueError("half_iteration_prepped: lin, gpf and gpb must be "
                         "on one CUDA device")
    _check_prepped(lin, gpf, gpb, W, U)
    if any(a.dtype != torch.float32 for a in args):
        raise TypeError("half_iteration_prepped: float32 inputs required")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("half_iteration_prepped: contiguous lin and frames "
                         "required")
    B, N = lin.shape
    n_w = N // W
    lib = kernels.load()
    out = torch.empty_like(lin)
    for name, t in (("lin", lin), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"half_iteration_prepped: {name} is not 16-byte"
                             " aligned (the kernel loads float4 vectors)")
    scr = torch.empty(scratch_numel(B * n_w, W, U), dtype=torch.float32,
                      device=lin.device)
    err = lib.turbo_half_iter_v1_launch(
        lin.data_ptr(), gpf.data_ptr(), gpb.data_ptr(), out.data_ptr(),
        scr.data_ptr(), B, n_w, W, U, pick_unroll(W, U),
        kernels.stream_of(lin))
    kernels.check(err, "turbo_half_iter_v1")
    count_launch("turbo_half_iter_v1", (B, N, W, U))
    return out
