"""Fused MRC + equalization + max-log LLR: the port's two-stage plain
version (a frozen copy), mrc_equalize then demap_llr, on any device."""
from __future__ import annotations

from ..phy.equalize import mrc_equalize
from .llr import demap_llr


def mrc_llr(y, H, n0_total, Qm: int):
    """y, H [..., A]; n0_total a number or [...]-broadcastable -> LLRs
    [..., Qm]."""
    x_hat, n0_eff = mrc_equalize(y, H, n0_total)
    return demap_llr(x_hat, n0_eff, Qm)
