"""Fused MRC + equalization + max-log LLR, and the max-log demap of an
already equalized stream: wrappers of csrc/mrc_llr.cu and their plain
PyTorch versions (counterpart of openair4g_tpu/ops/equalize_llr.py, whose
Pallas kernel serves both through `mrc_llr_pallas`)."""
from __future__ import annotations

import torch

from .. import kernels
from ..device import count_launch
from ..phy.equalize import mrc_equalize
from .llr import as_f32, demap_llr


def mrc_llr_ref(y, H, n0_total, Qm: int):
    """Two-stage plain version: mrc_equalize, then demap_llr."""
    x_hat, n0_eff = mrc_equalize(y, H, n0_total)
    return demap_llr(x_hat, n0_eff, Qm)


def _n0_operand(n0_total, lead: tuple, device):
    """n0 as a flat float32 tensor read as n0[i % period] over the flattened
    leading shape: a scalar (period 1), a tensor equal to the trailing
    leading dims (broadcast over the rest without copying), or anything
    else broadcastable (materialized to the full leading shape)."""
    n0 = as_f32(n0_total, device)
    while n0.dim() and n0.shape[0] == 1:
        n0 = n0[0]
    if n0.dim() <= len(lead) and tuple(n0.shape) == lead[len(lead) - n0.dim():]:
        return n0.contiguous().reshape(-1)
    return torch.broadcast_to(n0, lead).contiguous().reshape(-1)


def mrc_llr(y, H, n0_total, Qm: int):
    """y, H: [..., A] complex64; n0_total scalar or broadcastable to
    y.shape[:-1]. Returns [..., Qm] float32 LLRs (bit order of demap_llr).

    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if y.device.type == "cpu" and H.device.type == "cpu":
        return mrc_llr_ref(y, H, n0_total, Qm)
    if y.device.type != "cuda" or H.device != y.device:
        raise ValueError(f"mrc_llr: y on {y.device}, H on {H.device}; both "
                         "must be on one CUDA device")
    if y.dtype != torch.complex64 or H.dtype != torch.complex64:
        raise TypeError("mrc_llr: complex64 y and H required")
    if y.shape != H.shape or y.dim() < 2:
        raise ValueError(f"mrc_llr: y {tuple(y.shape)} and H "
                         f"{tuple(H.shape)} must be the same [..., A]")
    if not (y.is_contiguous() and H.is_contiguous()):
        raise ValueError("mrc_llr: contiguous y and H required")
    A = y.shape[-1]
    if A not in (1, 2) or Qm not in (2, 4, 6):
        raise ValueError(f"mrc_llr: A={A}, Qm={Qm} not built (A in 1,2; "
                         "Qm in 2,4,6)")
    lead = tuple(y.shape[:-1])
    n0 = _n0_operand(n0_total, lead, y.device)
    n = y.numel() // A
    lib = kernels.load()
    out = torch.empty(lead + (Qm,), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = lib.mrc_llr_launch(y.data_ptr(), H.data_ptr(), n0.data_ptr(),
                             out.data_ptr(), n, n0.numel(), A, Qm, stream)
    kernels.check(err, "mrc_llr")
    count_launch("mrc_llr")
    return out


demap_llr_fused_ref = demap_llr


def _element_stride(t) -> int | None:
    """The one element stride at which t's elements lie in row-major order
    (1 for a contiguous tensor, 2 for one layer of a [..., 2] tensor), or
    None when no single stride walks them, as in a broadcast view (stride
    0)."""
    if t.numel() <= 1:
        return 1
    s = None
    step = 1
    for size, stride in zip(reversed(t.shape), reversed(t.stride())):
        if size == 1:
            continue
        if s is None:
            s = stride
        elif stride != s * step:
            return None
        step *= size
    return s or None


def demap_llr_fused(x_hat, n0_eff, Qm: int):
    """Max-log LLRs of an equalized symbol stream with per-RE noise (the
    SFBC and MMSE receivers' tail): x_hat [...] complex64, n0_eff a scalar
    or broadcastable to x_hat.shape. Returns [..., Qm] float32, the bit
    order of ops/llr.demap_llr (its plain version).

    The CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    The kernel reads x_hat, and an n0_eff of x_hat's full shape, in place
    at one element stride each, so one layer of an MMSE output [B, N, 2]
    (x_hat[..., q], n0_eff[..., q]) needs no copy. In the simulators every
    n0_eff has that full shape (sfbc_combine repeats it per pair,
    mmse_detect and the rank-1 receivers give it per RE), so the period
    of its reads is n; a scalar or a smaller operand goes through
    _n0_operand."""
    if x_hat.device.type == "cpu":
        return demap_llr_fused_ref(x_hat, n0_eff, Qm)
    if x_hat.device.type != "cuda":
        raise ValueError(f"demap_llr_fused: x_hat on {x_hat.device}; it "
                         "must be on a CUDA device")
    if x_hat.dtype != torch.complex64:
        raise TypeError("demap_llr_fused: complex64 x_hat required")
    if Qm not in (2, 4, 6):
        raise ValueError(f"demap_llr_fused: Qm={Qm} not built (2, 4, 6)")
    lead = tuple(x_hat.shape)
    n = x_hat.numel()
    xs = _element_stride(x_hat)
    if xs is None:
        raise ValueError(f"demap_llr_fused: x_hat strides {x_hat.stride()} "
                         "are not one element stride")
    ns = _element_stride(n0_eff) if torch.is_tensor(n0_eff) else None
    if ns is not None and tuple(n0_eff.shape) == lead \
            and n0_eff.dtype == torch.float32:
        if n0_eff.device != x_hat.device:
            raise ValueError(f"demap_llr_fused: n0_eff on {n0_eff.device}, "
                             f"x_hat on {x_hat.device}")
        n0, period = n0_eff, n
    else:
        n0 = _n0_operand(n0_eff, lead, x_hat.device)
        ns, period = 1, n0.numel()
    lib = kernels.load()
    out = torch.empty(lead + (Qm,), dtype=torch.float32, device=x_hat.device)
    stream = torch.cuda.current_stream(x_hat.device).cuda_stream
    err = lib.demap_llr_launch(x_hat.data_ptr(), n0.data_ptr(),
                               out.data_ptr(), n, xs, ns, period, Qm, stream)
    kernels.check(err, "demap_llr")
    count_launch("demap_llr")
    return out
