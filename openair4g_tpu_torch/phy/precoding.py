"""DL precoding: codebooks, large-delay CDD, layer mapping, 36.211 §6.3.3-4
(counterpart of openair4g_tpu/phy/precoding.py). The precoders are
host-side numpy constants; precoding and the receiver's effective channel
H·W are einsums over the layer and port axes."""
from __future__ import annotations

import functools

import numpy as np
import torch

_S2 = 1.0 / np.sqrt(2.0)


@functools.lru_cache(maxsize=None)
def codebook_2tx(rank: int) -> np.ndarray:
    """2-antenna-port codebook, 36.211 Table 6.3.4.2.3-1:
    rank 1 -> [4, 2, 1]; rank 2 -> [3, 2, 2] (index 0 is the TM3 identity)."""
    if rank == 1:
        cols = np.array([[1, 1], [1, -1], [1, 1j], [1, -1j]],
                        np.complex64) * _S2
        return cols[:, :, None]
    w0 = np.eye(2, dtype=np.complex64) * _S2
    w1 = np.array([[1, 1], [1, -1]], np.complex64) / 2.0
    w2 = np.array([[1, 1j], [1, -1j]], np.complex64) / 2.0
    return np.stack([w0, w1, w2])


@functools.lru_cache(maxsize=None)
def cdd_precoders_2tx(n_re: int) -> np.ndarray:
    """Large-delay CDD effective precoders for 2 ports / 2 layers,
    W_eff(i) = W D(i) U with W = I/sqrt2, U = [[1,1],[1,-1]]/sqrt2,
    D(i) = diag(1, (-1)^i): two matrices alternating. Returns [n_re, 2, 2]."""
    U = np.array([[1, 1], [1, -1]], np.complex64) * _S2
    out = np.zeros((2, 2, 2), np.complex64)
    for i in range(2):
        D = np.diag([1.0, (-1.0) ** i]).astype(np.complex64)
        out[i] = _S2 * np.eye(2) @ D @ U
    return out[np.arange(n_re) % 2]


def layer_map(cw_syms: list):
    """Codeword-to-layer mapping, one codeword per layer:
    [x0 [B, N], x1 [B, N]] -> s [B, N, L]."""
    return torch.stack(cw_syms, dim=-1)


def precode(s, W):
    """s [B, N, L] layer symbols, W [N, P, L] or [P, L] -> tx [B, N, P]
    (W is taken in s's dtype)."""
    W = torch.as_tensor(W, dtype=s.dtype, device=s.device)
    if W.dim() == 2:
        return torch.einsum("bnl,pl->bnp", s, W)
    return torch.einsum("bnl,npl->bnp", s, W)


def effective_channel(H, W):
    """H [B, R, N, P] per-RE channel, W [N, P, L] or [P, L] ->
    He [B, N, R, L] (detection layout; W is taken in H's dtype)."""
    W = torch.as_tensor(W, dtype=H.dtype, device=H.device)
    if W.dim() == 2:
        return torch.einsum("brnp,pl->bnrl", H, W)
    return torch.einsum("brnp,npl->bnrl", H, W)
