"""Fused MRC + equalization + max-log LLR: wrapper of csrc/mrc_llr.cu and its
plain PyTorch version (counterpart of openair4g_tpu/ops/equalize_llr.py,
whose Pallas kernel `mrc_llr_pallas` the CUDA kernel replaces)."""
from __future__ import annotations

import torch

from .. import kernels
from ..device import count_launch
from ..phy.equalize import mrc_equalize
from .llr import demap_llr


def mrc_llr_ref(y, H, n0_total, Qm: int):
    """Two-stage plain version: mrc_equalize, then demap_llr."""
    x_hat, n0_eff = mrc_equalize(y, H, n0_total)
    return demap_llr(x_hat, n0_eff, Qm)


def _n0_operand(n0_total, lead: tuple, device):
    """n0 as a flat float32 tensor read as n0[i % period] over the flattened
    leading shape: a scalar (period 1), a tensor equal to the trailing
    leading dims (broadcast over the rest without copying), or anything
    else broadcastable (materialized to the full leading shape)."""
    n0 = torch.as_tensor(n0_total, dtype=torch.float32, device=device)
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
