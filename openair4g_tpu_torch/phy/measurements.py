"""UE and eNB radio measurements: RSRP, RSSI, RSRQ, the noise power, the
wideband CQI, and the eNB's uplink per-RB power and SNR (counterpart of
openair4g_tpu/phy/measurements.py). Each is a masked reduction over the
resource grid, batched over trials.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import device_plan
from .resource_grid import GridMap


@functools.lru_cache(maxsize=None)
def _port0_plan(gm: GridMap, device) -> dict:
    """Port 0's pilot positions and conjugated values, its pilot symbols
    and the occupied band's bins, on `device`, uploaded once."""
    own = gm.pilot_port == 0
    fp = gm.fp

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)
    return {"sym": idx(gm.pilot_sym[own]), "bin": idx(gm.pilot_bin[own]),
            "sc": idx(gm.pilot_sc[own]),
            "ref": torch.as_tensor(np.conj(gm.pilot_val[own]).astype(
                np.complex64), device=device),
            "syms": idx(np.unique(gm.pilot_sym[own])),
            "occ": idx(fp.sc_to_bin(np.arange(fp.n_sc)))}


def measure(rgrid, gm: GridMap, H_hat=None):
    """rgrid [B, nsym, n_fft] -> dict of per-trial measurements.

    rsrp: mean |RE|^2 over port 0's RS REs (linear, per RE); rssi_per_sc:
    mean power per occupied subcarrier over the pilot symbols; rsrq:
    rsrp / rssi_per_sc (36.214's N_RB RSRP / RSSI, per subcarrier). With
    H_hat [B, nsym, n_sc], also n0_hat (the LS pilot estimate's power
    about H_hat at the pilots) and snr_hat."""
    p = _port0_plan(gm, rgrid.device)
    rs_re = rgrid[:, p["sym"], p["bin"]]                 # [B, Np_tot]
    rsrp = torch.mean(rs_re.abs() ** 2, dim=-1)
    band = rgrid[:, p["syms"]][:, :, p["occ"]]           # [B, n_ps, n_sc]
    rssi_per_sc = torch.mean(band.abs() ** 2, dim=(-1, -2))
    out = dict(rsrp=rsrp, rssi_per_sc=rssi_per_sc,
               rsrq=rsrp / torch.clamp(rssi_per_sc, min=1e-12))
    if H_hat is not None:
        h_at_p = H_hat[:, p["sym"], p["sc"]]
        out["n0_hat"] = torch.mean((rs_re * p["ref"] - h_at_p).abs() ** 2,
                                   dim=-1)
        sig = torch.mean(h_at_p.abs() ** 2, dim=-1)
        out["snr_hat"] = sig / torch.clamp(out["n0_hat"], min=1e-12)
    return out


# 36.213 Table 7.2.3-1 CQI <-> spectral efficiency (bits/RE); used in
# float32, as the reference's device code uses it
_CQI_EFF = np.array([0.0, 0.1523, 0.2344, 0.3770, 0.6016, 0.8770, 1.1758,
                     1.4766, 1.9141, 2.4063, 2.7305, 3.3223, 3.9023, 4.5234,
                     5.1152, 5.5547, 6.2266], np.float64)


def wideband_cqi(snr_linear):
    """SNR -> CQI index 0..16 (the table's 17 rows): the highest whose
    efficiency is at most 90 % (a 1 dB margin) of the AWGN capacity
    log2(1 + SNR), formed as ln(1 + SNR) / ln 2 in float32, as the
    reference forms it."""
    eff = torch.log(1.0 + snr_linear) / float(np.log(np.float32(2.0)))
    table = device_plan(_CQI_EFF, snr_linear.device, dtype=torch.float32)
    return torch.sum(table <= eff[..., None] * 0.9, dim=-1) - 1


def enb_measure_ul(rgrid, pm, n_alloc_rb_mask: np.ndarray):
    """eNB uplink measurements: per-RB received power across the band, the
    noise and interference floor from the RBs outside every allocation,
    and the SNR of the allocated RBs. rgrid [B, nsym, n_fft]; pm a
    scfdma.PuschMap (for the band); n_alloc_rb_mask [n_rb] bool, True
    where some UE transmits."""
    fp = pm.fp
    dev = rgrid.device
    used = np.asarray(n_alloc_rb_mask, bool)
    occ = torch.as_tensor(fp.sc_to_bin(np.arange(fp.n_sc)).astype(np.int64),
                          device=dev)
    p_sc = torch.mean(rgrid[:, :, occ].abs() ** 2, dim=1)   # [B, n_sc]
    p_rb = p_sc.reshape(p_sc.shape[0], fp.n_rb, 12).mean(-1)
    mask = torch.as_tensor(used, device=dev)
    zero = p_rb.new_zeros(())
    n_empty = int((~used).sum())
    if n_empty:
        n0_hat = torch.sum(torch.where(~mask, p_rb, zero), -1) / n_empty
    else:
        n0_hat = p_rb.new_zeros(p_rb.shape[0])
    p_sig = torch.sum(torch.where(mask, p_rb, zero), -1) \
        / max(int(used.sum()), 1)
    snr = (p_sig - n0_hat) / torch.clamp(n0_hat, min=1e-12)
    return dict(p_rb=p_rb, n0_hat=n0_hat,
                snr_db=10.0 * torch.log10(torch.clamp(snr, min=1e-9)))
