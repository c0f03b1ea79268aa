"""PHICH: the HARQ ACK/NACK indicator channel, 36.211 §6.9 (counterpart of
openair4g_tpu/phy/phich.py).

BPSK HI repeated 3 times and spread by one of 8 length-4 orthogonal
sequences (4 Walsh x {1, j}); 8 sequences share a group of 3 REGs. A
group is 12 complex REs; despreading all 8 sequences is one matmul,
batched over trials.
"""
from __future__ import annotations

import functools

import numpy as np

from ..config import FrameParms
from ..device import device_plan
from ..ops.gold import gold_sequence
from .control_region import _regs_in_symbol, phich_reg_indices

N_SF = 4  # spreading factor, normal CP

# 36.211 Table 6.9.1-2: orthogonal sequences w (normal CP), index 0..7
_W = np.array([
    [1, 1, 1, 1],
    [1, -1, 1, -1],
    [1, 1, -1, -1],
    [1, -1, -1, 1],
    [1j, 1j, 1j, 1j],
    [1j, -1j, 1j, -1j],
    [1j, 1j, -1j, -1j],
    [1j, -1j, -1j, 1j]], np.complex64)


def phich_scramble(nid_cell: int, ns: int) -> np.ndarray:
    """[12] scrambling chips 1 - 2c(i) of one group (c_init 36.211
    §6.9.1)."""
    cinit = ((ns // 2 + 1) * (2 * nid_cell + 1) << 9) + nid_cell
    return 1.0 - 2.0 * gold_sequence(cinit, 12).astype(np.float64)


def phich_group_tx(acks: np.ndarray, nid_cell: int, ns: int) -> np.ndarray:
    """One PHICH group: acks [8] in {0 (NACK), 1 (ACK), -1 (off)} -> [12]
    complex REs (3 REGs x 4, before RE mapping): d(i) = w(i mod 4) (1 - 2b)
    c(i) over the 12 chips, ACK as BPSK +1."""
    c = phich_scramble(nid_cell, ns)
    out = np.zeros(12, np.complex128)
    for seq in range(8):
        if acks[seq] < 0:
            continue
        s = 1.0 if acks[seq] else -1.0
        out += s * np.tile(_W[seq], 3) * c
    return (out / np.sqrt(2)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _despread_matrix(nid_cell: int, ns: int) -> np.ndarray:
    """[12, 8] conj(w c)^T / 12, built in double and used as complex64,
    as the reference's device code uses it."""
    ref = np.tile(_W, (1, 3)) * phich_scramble(nid_cell, ns)[None, :]
    return (np.conj(ref).T / 12.0).astype(np.complex64)


def phich_group_rx(rx12, nid_cell: int, ns: int):
    """rx12 [B, 12] (equalized) -> decision variables z [B, 8], one per
    sequence: Re(z) > 0 is ACK, < 0 NACK, near 0 off. The {1, j} pairs are
    orthogonal in the real part only; their cross-talk lands on the
    imaginary axis."""
    return rx12 @ device_plan(_despread_matrix(nid_cell, ns), rx12.device)


@functools.lru_cache(maxsize=None)
def phich_reg_positions(n_rb: int, nid_cell: int, n_group: int = 1):
    """[n_group, 12] symbol-0 subcarriers of n_group PHICH groups: the REGs
    control_region.make_control_region_map(n_phich_groups=...) keeps from
    the PDCCH, so the two never collide."""
    fp = FrameParms(n_rb=n_rb, n_id_cell=nid_cell)
    regs = _regs_in_symbol(fp, 0)
    return np.stack([np.concatenate([regs[i] for i in idx])
                     for idx in phich_reg_indices(fp, n_group)])
