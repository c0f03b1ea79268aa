"""Fused MRC + equalization + max-log LLR, and the max-log demap of an
already equalized stream: wrappers of csrc/mrc_llr.cu and their plain
PyTorch versions (counterpart of openair4g_tpu/ops/equalize_llr.py, whose
Pallas kernel serves both through `mrc_llr_pallas`).

The kernels walk their REs as [rows, cols] with one row stride and one RE
stride an operand (and one antenna stride for y and H), so they read
interleaved [..., A] tensors, [B, A, N] antenna planes given as a
transposed view, one layer of a [..., 2] tensor and a broadcast n0 where
they lie. How the leading shape splits into rows and cols is decided here
(`_rows_cols`), in plain Python that the CPU tests reach."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import kernels
from ..device import count_launch
from ..phy.equalize import mrc_equalize
from .llr import as_f32, demap_llr


def mrc_llr_ref(y, H, n0_total, Qm: int):
    """Two-stage plain version: mrc_equalize, then demap_llr."""
    x_hat, n0_eff = mrc_equalize(y, H, n0_total)
    return demap_llr(x_hat, n0_eff, Qm)


def _one_stride(sizes, strides) -> int | None:
    """The one element stride that walks dims of these sizes and strides in
    row-major order: 1 for contiguous dims, 2 for one layer of a [..., 2]
    tensor, 0 for a broadcast view or for dims that hold one element; None
    when no single stride walks them (a transpose, a cropped row)."""
    s = None
    step = 1
    for size, stride in zip(reversed(sizes), reversed(strides)):
        if size == 1:
            continue
        if s is None:
            s = stride
        elif stride != s * step:
            return None
        step *= size
    return s or 0


@functools.lru_cache(maxsize=512)
def _rows_cols(lead: tuple, strides: tuple) -> tuple | None:
    """Split the leading shape into rows = lead[:k] and cols = lead[k:] at
    the least k for which every operand (one tuple of strides each) walks
    its rows and its cols with one stride each. Returns (rows, cols,
    ((row stride, col stride), ...)), or None when no k does. Cached: a
    simulator asks for the same few layouts on every step."""
    for k in range(max(len(lead), 1)):
        walks = tuple((_one_stride(lead[:k], st[:k]),
                       _one_stride(lead[k:], st[k:])) for st in strides)
        if all(r is not None and c is not None for r, c in walks):
            return math.prod(lead[:k]), math.prod(lead[k:]), walks
    return None


def _n0_view(n0, lead: tuple, device) -> tuple:
    """n0 for a kernel: (None, the number) for a Python or numpy number,
    which goes in as a kernel argument with no tensor and no launch; else
    (float32 tensor broadcast to the leading shape as a view, 0.0). A
    tensor on another device than the operands' raises ValueError."""
    if not torch.is_tensor(n0) and np.ndim(n0) == 0:
        return None, float(n0)
    if torch.is_tensor(n0) and n0.device != torch.device(device):
        raise ValueError(f"n0 on {n0.device}, the other operands on "
                         f"{device}")
    return torch.broadcast_to(as_f32(n0, device), lead), 0.0


def _split(name: str, lead: tuple, strides: tuple, n0):
    """_rows_cols over the operands' strides and n0's; an n0 view that no
    split walks (not a per-RE, per-row or full-shape one) is materialized
    and tried again. Returns (split, n0); raises ValueError when the other
    operands' layout is the obstacle, or the split is past the kernels'
    32-bit indices."""
    split = _rows_cols(lead, strides + ((n0.stride(),) if n0 is not None
                                        else ()))
    if split is None and n0 is not None:
        n0 = n0.contiguous()
        split = _rows_cols(lead, strides + (n0.stride(),))
    if split is None or not (split[0] < 2 ** 31 and split[1] <= 2 ** 30):
        raise ValueError(f"{name}: shape {lead} with strides {strides} is "
                         "not rows x cols of one row stride and one RE "
                         "stride an operand (rows under 2^31, cols at most "
                         "2^30)")
    return split, n0


def mrc_llr(y, H, n0_total, Qm: int):
    """y, H: [..., A] complex64; n0_total a number, or a tensor
    broadcastable to y.shape[:-1]. Returns [..., Qm] float32 LLRs (bit order
    of demap_llr), contiguous.

    The CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    y and H may be strided views, as long as their leading dims walk as rows
    x cols with one stride each (`_rows_cols`): antenna planes [B, A, N] go
    in as `y.transpose(1, 2)` without a copy. Any other layout raises
    ValueError. A number for n0_total costs no tensor and no launch."""
    if y.device.type == "cpu" and H.device.type == "cpu":
        return mrc_llr_ref(y, H, n0_total, Qm)
    if y.device.type != "cuda" or H.device != y.device:
        raise ValueError(f"mrc_llr: y on {y.device}, H on {H.device}; both "
                         "must be on one CUDA device")
    if y.dtype != torch.complex64 or H.dtype != torch.complex64:
        raise TypeError("mrc_llr: complex64 y and H required")
    if y.shape != H.shape or y.dim() < 2 or y.numel() == 0:
        raise ValueError(f"mrc_llr: y {tuple(y.shape)} and H "
                         f"{tuple(H.shape)} must be the same non-empty "
                         "[..., A]")
    A = y.shape[-1]
    if A not in (1, 2) or Qm not in (2, 4, 6):
        raise ValueError(f"mrc_llr: A={A}, Qm={Qm} not built (A in 1,2; "
                         "Qm in 2,4,6)")
    y, H = y.resolve_conj(), H.resolve_conj()
    lead = tuple(y.shape[:-1])
    n0, n0_scalar = _n0_view(n0_total, lead, y.device)
    split, n0 = _split("mrc_llr", lead, (y.stride()[:-1], H.stride()[:-1]),
                       n0)
    rows, cols, walks = split
    lib = kernels.load()
    out = torch.empty(lead + (Qm,), dtype=torch.float32, device=y.device)
    err = lib.mrc_llr_launch(
        y.data_ptr(), H.data_ptr(), None if n0 is None else n0.data_ptr(),
        n0_scalar, out.data_ptr(), rows, cols, *walks[0], y.stride(-1),
        *walks[1], H.stride(-1), *(walks[2] if n0 is not None else (0, 0)),
        A, Qm, kernels.stream_of(y))
    kernels.check(err, "mrc_llr")
    count_launch("mrc_llr")
    return out


demap_llr_fused_ref = demap_llr


def demap_llr_fused(x_hat, n0_eff, Qm: int):
    """Max-log LLRs of an equalized symbol stream with per-RE noise (the
    SFBC and MMSE receivers' tail): x_hat [...] complex64, n0_eff a number
    or a tensor broadcastable to x_hat.shape. Returns [..., Qm] float32,
    the bit order of ops/llr.demap_llr (its plain version).

    The CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    The kernel reads x_hat and n0_eff in place at a row and an RE stride
    each, so one layer of an MMSE output [B, N, 2] (x_hat[..., q],
    n0_eff[..., q]) and a broadcast n0_eff need no copy; an x_hat that no
    split into rows x cols walks raises ValueError."""
    if x_hat.device.type == "cpu":
        return demap_llr_fused_ref(x_hat, n0_eff, Qm)
    if x_hat.device.type != "cuda":
        raise ValueError(f"demap_llr_fused: x_hat on {x_hat.device}; it "
                         "must be on a CUDA device")
    if x_hat.dtype != torch.complex64:
        raise TypeError("demap_llr_fused: complex64 x_hat required")
    if Qm not in (2, 4, 6) or x_hat.numel() == 0:
        raise ValueError(f"demap_llr_fused: Qm={Qm} not built (2, 4, 6), or "
                         f"an empty x_hat {tuple(x_hat.shape)}")
    x_hat = x_hat.resolve_conj()
    lead = tuple(x_hat.shape)
    n0, n0_scalar = _n0_view(n0_eff, lead, x_hat.device)
    split, n0 = _split("demap_llr_fused", lead, (x_hat.stride(),), n0)
    rows, cols, walks = split
    lib = kernels.load()
    out = torch.empty(lead + (Qm,), dtype=torch.float32, device=x_hat.device)
    err = lib.demap_llr_launch(
        x_hat.data_ptr(), None if n0 is None else n0.data_ptr(), n0_scalar,
        out.data_ptr(), rows, cols, *walks[0],
        *(walks[1] if n0 is not None else (0, 0)), Qm,
        kernels.stream_of(x_hat))
    kernels.check(err, "demap_llr")
    count_launch("demap_llr")
    return out
