"""SC-FDMA (PUSCH) modulation: transform precoding and RE mapping, 36.211
§5.6 (counterpart of openair4g_tpu/phy/scfdma.py).

The M-point DFT and IDFT are a matmul with the unitary DFT matrix, one
code path for every 2^a 3^b 5^c size, as in the reference; the matrix is
built on the host once per size and uploaded once per device (1200 x 1200
complex64 at 100 PRB, 11.5 MB). The channel interleaver (36.212
§5.2.2.8, data only) is a static permutation applied in the symbol ->
grid gather.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..device import device_plan, mm


@functools.lru_cache(maxsize=None)
def _dft_mat(m: int) -> np.ndarray:
    n = np.arange(m)
    w = np.exp(-2j * np.pi * np.outer(n, n) / m) / np.sqrt(m)
    return w.astype(np.complex64)


def _conj_t(w: np.ndarray) -> np.ndarray:
    return w.conj().T


def transform_precode(x):
    """Unitary M-point DFT along the last axis (DFT-spread OFDM)."""
    return mm(x, device_plan(_dft_mat(x.shape[-1]), x.device))


def transform_deprecode(x):
    """Unitary M-point IDFT along the last axis (despread)."""
    return mm(x, device_plan(_dft_mat(x.shape[-1]), x.device, _conj_t))


def dmrs_symbol_indices(fp: FrameParms) -> tuple:
    """SC-FDMA symbols carrying the PUSCH DMRS (36.211 Table 5.5.2.1.1-2):
    symbol 3 of each slot for normal CP, symbol 2 for extended."""
    l = 3 if fp.normal_cp else 2
    return (l, l + fp.symbols_per_slot)


@dataclass(frozen=True)
class PuschMap:
    """Static RE and interleaver maps for one PUSCH allocation. With
    frequency hopping (36.211 §5.3.4) the second slot sits at `rb_offset2`
    and the per-symbol bin tables carry the hop."""
    fp: FrameParms
    n_rb_alloc: int
    rb_offset: int
    m_sc: int
    data_syms: np.ndarray    # [n_data_sym] SC-FDMA symbol indices
    dmrs_syms: np.ndarray    # [2]
    sc_bins: np.ndarray      # [m_sc] FFT bins (slot 0 / unhopped)
    interleave: np.ndarray   # [n_mod_sym] perm: time-interleaved -> serial
    rb_offset2: int = None   # second-slot PRB start
    sc_bins_sym: np.ndarray = None   # [n_data_sym, m_sc] per-symbol bins
    dmrs_bins: np.ndarray = None     # [2, m_sc] per-DMRS-symbol bins

    @property
    def hopped(self) -> bool:
        return self.rb_offset2 is not None and \
            self.rb_offset2 != self.rb_offset

    @functools.cached_property
    def deinterleave(self) -> np.ndarray:
        """[n_mod_sym] the inverse of `interleave`."""
        inv = np.empty_like(self.interleave)
        inv[self.interleave] = np.arange(len(self.interleave),
                                         dtype=np.int32)
        return inv


@functools.lru_cache(maxsize=None)
def make_pusch_map(n_rb: int, n_rb_alloc: int, rb_offset: int = 0,
                   normal_cp: bool = True, srs: bool = False,
                   rb_offset2: int | None = None) -> PuschMap:
    """srs=True vacates the last SC-FDMA symbol for the sounding RS;
    rb_offset2 is the second slot's PRB start under frequency hopping
    (phy/hopping.pusch_hopped_rb_start)."""
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp)
    m_sc = 12 * n_rb_alloc
    dmrs = dmrs_symbol_indices(fp)
    skip = set(dmrs) | ({fp.symbols_per_subframe - 1} if srs else set())
    data_syms = np.asarray([s for s in range(fp.symbols_per_subframe)
                            if s not in skip], np.int32)

    # uplink subcarriers are contiguous (no DC puncture), mapped
    # symmetrically around bin 0
    def bins_at(off):
        f_idx = off * 12 + np.arange(m_sc, dtype=np.int64) - 6 * n_rb
        return np.mod(f_idx, fp.n_fft).astype(np.int32)
    sc_bins = bins_at(rb_offset)
    off2 = rb_offset if rb_offset2 is None else rb_offset2
    bins2 = bins_at(off2)
    half = fp.symbols_per_subframe // 2
    sc_bins_sym = np.stack([sc_bins if l < half else bins2
                            for l in data_syms])
    dmrs_bins = np.stack([sc_bins if l < half else bins2 for l in dmrs])
    # 36.212 §5.2.2.8, data only: serial symbol i lands at (sym, sc) =
    # (i % C, i // C); stored as the gather for the [nsym, m_sc] layout
    C = len(data_syms)
    idx = np.arange(C * m_sc).reshape(m_sc, C).T.reshape(-1)
    return PuschMap(fp=fp, n_rb_alloc=n_rb_alloc, rb_offset=rb_offset,
                    m_sc=m_sc, data_syms=data_syms,
                    dmrs_syms=np.asarray(dmrs, np.int32),
                    sc_bins=sc_bins, interleave=idx.astype(np.int32),
                    rb_offset2=off2, sc_bins_sym=sc_bins_sym,
                    dmrs_bins=dmrs_bins)


def _long(a, dev):
    return device_plan(a, dev, dtype=torch.long)


def _col(a: np.ndarray) -> np.ndarray:
    return a[:, None]


def _c64(a: np.ndarray) -> np.ndarray:
    return a.astype(np.complex64)


def pusch_fill_grid_x(x, pm: PuschMap, dmrs_val: np.ndarray):
    """x [B, C, M] interleaved modulation symbols (as ops/uci.uci_multiplex
    gives them) -> grid [B, nsym, n_fft]. `dmrs_val` [M] must outlive the
    caller's use (it is uploaded once)."""
    B, dev, fp = x.shape[0], x.device, pm.fp
    grid = torch.zeros(B, fp.symbols_per_subframe, fp.n_fft,
                       dtype=torch.complex64, device=dev)
    grid[:, device_plan(pm.data_syms, dev, _col, torch.long),
         _long(pm.sc_bins_sym, dev)] = transform_precode(x)
    grid[:, device_plan(pm.dmrs_syms, dev, _col, torch.long),
         _long(pm.dmrs_bins, dev)] = device_plan(dmrs_val, dev, _c64)
    return grid


def pusch_extract(grid, pm: PuschMap):
    """grid [B, nsym, n_fft] -> (data [B, C, M], dmrs [B, 2, M])."""
    dev = grid.device
    data = grid[:, device_plan(pm.data_syms, dev, _col, torch.long),
                _long(pm.sc_bins_sym, dev)]
    dmrs = grid[:, device_plan(pm.dmrs_syms, dev, _col, torch.long),
                _long(pm.dmrs_bins, dev)]
    return data, dmrs


def _conj(a: np.ndarray) -> np.ndarray:
    return np.conj(a)


