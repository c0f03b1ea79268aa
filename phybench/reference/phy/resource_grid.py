"""Downlink resource-element mapping for one subframe, 36.211 §6.2/6.10
(counterpart of openair4g_tpu/phy/resource_grid.py). The data and pilot
RE coordinates are static host-side index arrays (`GridMap`); on the
device, grid fill and extract are single gathers."""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..ops.gold import gold_sequence


def pilot_symbol_indices(fp: FrameParms) -> tuple:
    """Symbols carrying cell-specific RS for ports 0/1 within a subframe."""
    return (0, 4, 7, 11) if fp.normal_cp else (0, 3, 6, 9)


def pilot_sc_positions(fp: FrameParms, sym: int, port: int = 0) -> np.ndarray:
    """Occupied-subcarrier indices of port-`port` pilots in symbol `sym`:
    spacing 6, offset (v + nushift) mod 6 with v = 0 on slot-symbol 0 and 3
    on the mid-slot pilot symbol (port 1 is the complement)."""
    v = 0 if sym % fp.symbols_per_slot == 0 else 3
    if port == 1:
        v = 3 - v
    return np.arange((v + fp.nushift) % 6, fp.n_sc, 6, dtype=np.int32)


def pilot_values(fp: FrameParms, subframe: int, sym: int) -> np.ndarray:
    """QPSK cell-specific RS values for (subframe, symbol), 36.211 §6.10.1:
    c_init = 2^10*(7*(ns+1)+l+1)*(2*Nid+1) + 2*Nid + N_CP."""
    ns = 2 * subframe + (1 if sym >= fp.symbols_per_slot else 0)
    l = sym % fp.symbols_per_slot
    cinit = (1 << 10) * (7 * (ns + 1) + l + 1) * (2 * fp.n_id_cell + 1) \
        + 2 * fp.n_id_cell + (1 if fp.normal_cp else 0)
    n_rb_max = 110
    c = gold_sequence(cinit, 4 * n_rb_max).astype(np.float64)
    m = np.arange(2 * fp.n_rb) + (n_rb_max - fp.n_rb)
    re = (1 - 2 * c[2 * m]) / np.sqrt(2)
    im = (1 - 2 * c[2 * m + 1]) / np.sqrt(2)
    return (re + 1j * im).astype(np.complex64)


@dataclass(frozen=True, eq=False)
class GridMap:
    """Static RE coordinates for one subframe configuration."""
    fp: FrameParms
    n_pdcch: int
    n_data_re: int
    data_sym: np.ndarray     # [n_data_re] symbol index
    data_sc: np.ndarray      # [n_data_re] occupied-subcarrier index
    data_bin: np.ndarray     # [n_data_re] FFT bin
    pilot_sym: np.ndarray    # [n_pilot] symbol index
    pilot_sc: np.ndarray
    pilot_bin: np.ndarray
    pilot_val: np.ndarray    # [n_pilot] complex64
    pilot_port: np.ndarray   # [n_pilot] antenna port of each pilot
    nports: int = 1


@functools.lru_cache(maxsize=None)
def make_grid_map(n_rb: int, n_pdcch: int, n_id_cell: int = 0,
                  subframe: int = 7, nports: int = 1,
                  normal_cp: bool = True,
                  rb_alloc: tuple | None = None) -> GridMap:
    """Data fill order: symbols in time order, then subcarriers in frequency
    order. With nports == 1 only port-0 pilots are punctured; with
    nports == 2 both ports' pilot positions are skipped. rb_alloc =
    (rb_start, n_prb) restricts the data REs to a contiguous allocation
    (DCI format 1A type 2); the pilots stay full-band."""
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp, n_id_cell=n_id_cell)
    psyms = set(pilot_symbol_indices(fp))
    k_lo, k_hi = (0, fp.n_sc) if rb_alloc is None else \
        (12 * rb_alloc[0], 12 * (rb_alloc[0] + rb_alloc[1]))
    data_sym, data_sc = [], []
    for sym in range(n_pdcch, fp.symbols_per_subframe):
        skip = set()
        if sym in psyms:
            skip = set(pilot_sc_positions(fp, sym, 0).tolist())
            if nports == 2:
                skip |= set(pilot_sc_positions(fp, sym, 1).tolist())
        for k in range(k_lo, k_hi):
            if k not in skip:
                data_sym.append(sym)
                data_sc.append(k)
    data_sym = np.asarray(data_sym, np.int32)
    data_sc = np.asarray(data_sc, np.int32)

    pilot_sym, pilot_sc, pilot_val, pilot_port = [], [], [], []
    for sym in pilot_symbol_indices(fp):
        vals = pilot_values(fp, subframe, sym)
        for port in range(nports):
            scs = pilot_sc_positions(fp, sym, port)
            pilot_sym.append(np.full(len(scs), sym, np.int32))
            pilot_sc.append(scs)
            pilot_val.append(vals[:len(scs)])
            pilot_port.append(np.full(len(scs), port, np.int32))
    pilot_sc = np.concatenate(pilot_sc)
    return GridMap(fp=fp, n_pdcch=n_pdcch, n_data_re=len(data_sym),
                   data_sym=data_sym, data_sc=data_sc,
                   data_bin=fp.sc_to_bin(data_sc),
                   pilot_sym=np.concatenate(pilot_sym), pilot_sc=pilot_sc,
                   pilot_bin=fp.sc_to_bin(pilot_sc),
                   pilot_val=np.concatenate(pilot_val),
                   pilot_port=np.concatenate(pilot_port), nports=nports)


def _fill_index(gm: GridMap) -> np.ndarray:
    """[nsym*n_fft] source indices into concat([data, pilots, zero])."""
    fp = gm.fp
    nd, npi = gm.n_data_re, len(gm.pilot_sym)
    idx = np.full(fp.symbols_per_subframe * fp.n_fft, nd + npi, np.int64)
    idx[gm.data_sym.astype(np.int64) * fp.n_fft + gm.data_bin] = \
        np.arange(nd)
    idx[gm.pilot_sym.astype(np.int64) * fp.n_fft + gm.pilot_bin] = \
        nd + np.arange(npi)
    return idx


def fill_grid(symbols, gm: GridMap):
    """symbols [B, n_data_re] complex -> grid [B, nsym, n_fft] complex64,
    with the cell-specific RS in place."""
    B = symbols.shape[0]
    fp = gm.fp
    plan = _grid_tensors(gm, symbols.device)
    symbols = symbols.to(torch.complex64)
    src = torch.cat([symbols, plan["pilot_val"].expand(B, -1),
                     symbols.new_zeros(B, 1)], dim=1)
    return src[:, plan["fill"]].reshape(B, fp.symbols_per_subframe, fp.n_fft)


@functools.lru_cache(maxsize=None)
def _grid_tensors(gm: GridMap, device) -> dict:
    """The map's fill and extract plans on `device`, uploaded once."""
    return {"fill": torch.as_tensor(_fill_index(gm), device=device),
            "pilot_val": torch.as_tensor(gm.pilot_val.astype(np.complex64),
                                         device=device),
            "data_sym": torch.as_tensor(gm.data_sym, dtype=torch.long,
                                        device=device),
            "data_sc": torch.as_tensor(gm.data_sc, dtype=torch.long,
                                       device=device),
            "data_bin": torch.as_tensor(gm.data_bin, dtype=torch.long,
                                        device=device),
            "pilot_sym": torch.as_tensor(gm.pilot_sym, dtype=torch.long,
                                         device=device),
            "pilot_bin": torch.as_tensor(gm.pilot_bin, dtype=torch.long,
                                         device=device)}


def extract_data_res(grid, gm: GridMap):
    """grid [B, nsym, n_fft] -> [B, n_data_re] (inverse of the fill order)."""
    plan = _grid_tensors(gm, grid.device)
    return grid[:, plan["data_sym"], plan["data_bin"]]


