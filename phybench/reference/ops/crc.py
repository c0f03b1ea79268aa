"""CRC attachment/checking per 3GPP TS 36.212 §5.1.1 (counterpart of
openair4g_tpu/ops/crc.py).

The CRC of a K-bit message is a GF(2) matrix product,
remainder = (bits @ H) mod 2, with H [K, L] built on the host. On the
device it is one float32 matmul: with TF32 off (device.py) every partial
sum is an integer below 2^24, so the sums are exact.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import device_plan  # (importing it sets full-f32 matmuls)

# Polynomial bit vectors, MSB (x^L) first, per 36.212 §5.1.1.
CRC_POLYS = {
    "crc24a": (24, 0x1864CFB),
    "crc24b": (24, 0x1800063),
    "crc16": (16, 0x11021),
    "crc12": (12, 0x180F),
    "crc8": (8, 0x19B),
}


def crc_bits_host(bits: np.ndarray, kind: str) -> np.ndarray:
    """Serial golden CRC: bits [K] in {0,1} MSB-first -> remainder [L]."""
    L, poly = CRC_POLYS[kind]
    reg = 0
    for b in np.asarray(bits, np.int64):
        reg = (reg << 1) | int(b)
        if reg >> L:
            reg ^= poly
    for _ in range(L):
        reg <<= 1
        if reg >> L:
            reg ^= poly
    return np.array([(reg >> (L - 1 - i)) & 1 for i in range(L)], np.int8)


@functools.lru_cache(maxsize=None)
def crc_matrix(K: int, kind: str) -> np.ndarray:
    """[K, L] GF(2) matrix H with crc(bits) = (bits @ H) mod 2; row i is
    the CRC of the message with only bit i set."""
    L, poly = CRC_POLYS[kind]
    H = np.zeros((K, L), np.int8)
    r = 1
    for _ in range(L):
        r <<= 1
        if r >> L:
            r ^= poly
    for i in range(K - 1, -1, -1):
        H[i] = [(r >> (L - 1 - j)) & 1 for j in range(L)]
        r <<= 1
        if r >> L:
            r ^= poly
    return H


def crc_remainder(bits, H: np.ndarray):
    """bits [..., K] in {0,1} -> remainder [..., L] as float32 {0., 1.}.
    H: a crc_matrix (cached, so it is uploaded once per device)."""
    Ht = device_plan(H, bits.device, dtype=torch.float32)
    return torch.remainder(bits.to(torch.float32) @ Ht, 2.0)


def crc_device(bits, kind: str):
    """Batched CRC. bits [..., K] in {0,1} -> remainder [..., L] float32."""
    return crc_remainder(bits, crc_matrix(bits.shape[-1], kind))


