"""Downlink channel estimation from the cell-specific RS (counterpart of
openair4g_tpu/phy/channel_est.py): the joint 2D-LMMSE estimator over all
pilots of the subframe, the per-pilot-symbol Wiener estimator with time
averaging or linear time interpolation, per antenna port, and the
decision-directed second pass over the detected data REs.

The estimator matrices, posterior error variances and delay priors are
host-side numpy (copied from the reference, whose module imports jax); on
the device each estimate is complex matmuls of least-squares estimates
with those matrices, and the pilot plans are uploaded once per device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import FrameParms
from ..device import device_plan
from .resource_grid import GridMap, pilot_symbol_indices


def _signed_freq_idx(fp: FrameParms, sc: np.ndarray) -> np.ndarray:
    half = 6 * fp.n_rb
    return np.where(sc < half, sc - half, sc - half + 1)


def _delay_prior(fp: FrameParms) -> np.ndarray:
    """Exponential delay-power prior over the CP support, tau_rms = CP/8."""
    L = fp.cp + 2
    p = np.exp(-np.arange(L) / (fp.cp / 8.0))
    return p / p.sum()


@functools.lru_cache(maxsize=None)
def _wiener_matrix(n_rb: int, pilot_off: int, n0: float,
                   normal_cp: bool = True) -> np.ndarray:
    """[Np, n_sc] complex64 Wiener interpolation matrix for pilots at
    subcarriers pilot_off + 6m (ls @ W -> H), exp delay prior over CP+2."""
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp)
    p_sc = np.arange(pilot_off, fp.n_sc, 6)
    taps = np.arange(fp.cp + 2)
    Fp = np.exp(-2j * np.pi * _signed_freq_idx(fp, p_sc)[:, None]
                * taps[None, :] / fp.n_fft)
    Fd = np.exp(-2j * np.pi * _signed_freq_idx(fp, np.arange(fp.n_sc))[:, None]
                * taps[None, :] / fp.n_fft)
    P = _delay_prior(fp)
    A = (Fp * P) @ Fp.conj().T + n0 * np.eye(len(p_sc))
    W = (Fd * P) @ Fp.conj().T @ np.linalg.inv(A)   # [n_sc, Np]
    return W.T.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _time_interp_weights(n_rb: int, normal_cp: bool = True) -> np.ndarray:
    """[nsym, n_pilot_sym] linear time-interpolation weights, clamped at the
    subframe edges."""
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp)
    psyms = np.asarray(pilot_symbol_indices(fp))
    Wt = np.zeros((fp.symbols_per_subframe, len(psyms)), np.float32)
    for l in range(fp.symbols_per_subframe):
        if l <= psyms[0]:
            Wt[l, 0] = 1.0
        elif l >= psyms[-1]:
            Wt[l, -1] = 1.0
        else:
            j = np.searchsorted(psyms, l) - 1
            t = (l - psyms[j]) / (psyms[j + 1] - psyms[j])
            Wt[l, j] = 1.0 - t
            Wt[l, j + 1] = t
    return Wt


def _port_pilot_arrays(gm: GridMap, port: int):
    """Per-pilot-symbol (sym, sc, bin, val) arrays [n_ps, Np] of one port."""
    own = gm.pilot_port == port
    n_ps = len(pilot_symbol_indices(gm.fp))
    Np = own.sum() // n_ps
    return (gm.pilot_sym[own].reshape(n_ps, Np),
            gm.pilot_sc[own].reshape(n_ps, Np),
            gm.pilot_bin[own].reshape(n_ps, Np),
            gm.pilot_val[own].reshape(n_ps, Np))


def make_wiener_stack(gm: GridMap, n0: float, port: int = 0) -> np.ndarray:
    """[n_pilot_sym, Np, n_sc, 2] float32 (re/im packed) Wiener matrices,
    one per pilot symbol's comb offset of antenna port `port`
    (convert.wiener_stack_from_reference makes the device tensor)."""
    _, pilot_sc, _, _ = _port_pilot_arrays(gm, port)
    c = np.stack([_wiener_matrix(gm.fp.n_rb, int(pilot_sc[s, 0] % 6),
                                 float(n0), gm.fp.normal_cp)
                  for s in range(pilot_sc.shape[0])])
    return np.stack([c.real, c.imag], axis=-1).astype(np.float32)


def estimate_channel(rgrid, gm: GridMap, wiener_stack, time_avg: bool = False,
                     port: int = 0):
    """rgrid [B, nsym, n_fft] -> H_hat [B, nsym, n_sc] for antenna port
    `port`: per pilot symbol, the LS estimates at its comb times that
    symbol's Wiener matrix (`wiener_stack`: complex64 [n_ps, Np, n_sc] on
    rgrid's device); then the mean over the pilot symbols (time_avg, the
    quasi-static mode) or linear interpolation between them."""
    fp = gm.fp
    p = _pilot_tensors(gm, port, rgrid.device)
    ls = rgrid[:, p["sym"], p["bin"]] * p["ref"]          # [B, n_ps, Np]
    h_p = torch.einsum("bpn,pnk->bpk", ls, wiener_stack)  # [B, n_ps, n_sc]
    B, n_sc = h_p.shape[0], h_p.shape[-1]
    if time_avg:
        return h_p.mean(dim=1, keepdim=True).expand(
            B, fp.symbols_per_subframe, n_sc)
    return torch.einsum("sp,bpk->bsk", p["time_interp"], h_p)


@functools.lru_cache(maxsize=None)
def _pilot_tensors(gm: GridMap, port: int, device) -> dict:
    """Port `port`'s pilot plan on `device`, uploaded once: symbol and FFT
    bin [n_ps, Np], conjugated reference values, and the linear
    time-interpolation weights [nsym, n_ps]."""
    pilot_sym, _, pilot_bin, pilot_val = _port_pilot_arrays(gm, port)
    fp = gm.fp
    return {
        "sym": torch.as_tensor(pilot_sym, dtype=torch.long, device=device),
        "bin": torch.as_tensor(pilot_bin, dtype=torch.long, device=device),
        "ref": torch.as_tensor(np.conj(pilot_val).astype(np.complex64),
                               device=device),
        "time_interp": torch.as_tensor(
            _time_interp_weights(fp.n_rb, fp.normal_cp),
            dtype=torch.complex64, device=device)}


def _comb_offsets(gm: GridMap, port: int) -> tuple:
    _, pilot_sc, _, _ = _port_pilot_arrays(gm, port)
    return tuple(int(pilot_sc[s, 0] % 6) for s in range(pilot_sc.shape[0]))


def _joint_terms(fp: FrameParms, offs: tuple, n0: float, prior):
    """(P, A, C) of the joint estimator: prior over the cp+2 delay taps,
    pilot covariance A = Fp P Fp^H + n0 I, cross term C = Fd P Fp^H."""
    all_sc = np.concatenate([np.arange(off, fp.n_sc, 6) for off in offs])
    taps = np.arange(fp.cp + 2)
    Fp = np.exp(-2j * np.pi * _signed_freq_idx(fp, all_sc)[:, None]
                * taps[None, :] / fp.n_fft)
    Fd = np.exp(-2j * np.pi * _signed_freq_idx(fp, np.arange(fp.n_sc))[:, None]
                * taps[None, :] / fp.n_fft)
    P = _delay_prior(fp) if prior is None else np.asarray(prior, float)
    A = (Fp * P) @ Fp.conj().T + n0 * np.eye(len(all_sc))
    C = (Fd * P) @ Fp.conj().T
    return P, A, C


@functools.lru_cache(maxsize=None)
def _wiener_joint_cached(fp: FrameParms, offs: tuple, n0: float, prior):
    _, A, C = _joint_terms(fp, offs, n0, prior)
    return (C @ np.linalg.inv(A)).T.astype(np.complex64)


def make_wiener_joint(gm: GridMap, n0: float, port: int = 0,
                      prior=None) -> np.ndarray:
    """[Np_total, n_sc, 2] float32 (re/im packed) joint estimator matrix:
    H_hat = ls @ W over all pilots of the subframe (quasi-static 2D LMMSE).
    `prior`: explicit delay-power prior over the cp+2 taps, else exp."""
    pr = None if prior is None else tuple(np.asarray(prior, float).tolist())
    c = _wiener_joint_cached(gm.fp, _comb_offsets(gm, port), float(n0), pr)
    return np.stack([c.real, c.imag], axis=-1).astype(np.float32)


def joint_err_var(gm: GridMap, n0: float, port: int = 0,
                  prior=None) -> np.ndarray:
    """[n_sc] float32 posterior error variance of the joint estimator."""
    P, A, C = _joint_terms(gm.fp, _comb_offsets(gm, port), n0, prior)
    W = C @ np.linalg.inv(A)
    post = float(np.sum(P)) - np.einsum("kp,kp->k", W, C.conj()).real
    return np.maximum(post, 0.0).astype(np.float32)


def measure_delay_prior(rgrid, gm: GridMap, n0: float,
                        port: int = 0, floor: float = 1e-4) -> np.ndarray:
    """Delay-power prior measured from received pilots (host numpy):
    per pilot symbol, LS estimates at the comb are projected onto the cp+2
    delay taps, tap powers averaged over batch and pilot symbols, the
    noise floor subtracted, then floored and normalized."""
    fp = gm.fp
    pilot_sym, pilot_sc, pilot_bin, pilot_val = _port_pilot_arrays(gm, port)
    n_ps = pilot_sym.shape[0]
    L = fp.cp + 2
    taps = np.arange(L)
    p_tap = np.zeros(L)
    noise_gain = np.zeros(L)
    rg = np.asarray(rgrid)
    for s in range(n_ps):
        f_idx = _signed_freq_idx(fp, pilot_sc[s])[:, None]
        F = np.exp(-2j * np.pi * f_idx * taps[None, :] / fp.n_fft)
        A = F.conj().T @ F + n0 * len(pilot_sc[s]) * np.eye(L)
        P = np.linalg.solve(A, F.conj().T)          # [L, Np]
        y = rg[:, int(pilot_sym[s, 0])][:, pilot_bin[s]]
        ls = y * np.conj(pilot_val[s])[None, :]
        g = ls @ P.T
        p_tap += np.mean(np.abs(g) ** 2, axis=0)
        noise_gain += n0 * np.sum(np.abs(P) ** 2, axis=1)
    p_tap = np.maximum(p_tap - noise_gain, 0.0) / n_ps
    p_tap = np.maximum(p_tap, floor * p_tap.max() + 1e-12)
    return p_tap / p_tap.sum()


def estimate_channel_joint(rgrid, gm: GridMap, wiener_joint, port: int = 0):
    """rgrid [B, nsym, n_fft] -> H_hat [B, nsym, n_sc]: one estimate from
    all pilots of the subframe, broadcast over symbols. `wiener_joint`:
    complex64 [Np_total, n_sc] tensor on rgrid's device."""
    fp = gm.fp
    p = _pilot_tensors(gm, port, rgrid.device)
    ls = rgrid[:, p["sym"].reshape(-1), p["bin"].reshape(-1)] \
        * p["ref"].reshape(-1)                            # [B, Np_total]
    h = ls @ wiener_joint
    return h[:, None].expand(h.shape[0], fp.symbols_per_subframe, h.shape[-1])


def pdp_prior(fp: FrameParms, delays_us, amps, delay_scale: float = 1.0,
              floor: float = 1e-4) -> np.ndarray:
    """Delay-power prior from a channel's actual PDP: tap powers split
    between the two nearest samples of the cp+2 support, plus a uniform
    floor (the est_prior="pdp" genie bound)."""
    L = fp.cp + 2
    fs = fp.n_fft * 15000.0
    P = np.full(L, floor, float)
    a = np.asarray(amps, float)
    a = a / a.sum()
    for d_us, p in zip(np.asarray(delays_us, float), a):
        pos = d_us * 1e-6 * delay_scale * fs
        i = int(np.floor(pos))
        frac = pos - i
        if i + 1 < L:
            P[i] += p * (1 - frac)
            P[i + 1] += p * frac
        elif i < L:
            P[i] += p
    return P / P.sum()


# --------------------------------------- decision-directed second pass --
# After a first-pass joint estimate, the detected data REs act as a dense
# pilot field: LS at every data RE, accumulated per subcarrier together
# with the pilots' LS, then one MMSE smoothing onto the delay subspace.

_LV64 = np.float32(1.0 / np.sqrt(42.0))   # 64QAM level unit


def qam_hard_slice(x, Qm: int):
    """Nearest unit-energy 36.211 constellation point of each equalized
    symbol, per axis."""
    if Qm == 2:
        lv = np.float32(1.0 / np.sqrt(2.0))
        return torch.complex(torch.sign(x.real) * lv, torch.sign(x.imag) * lv)
    if Qm == 4:
        lv = np.float32(1.0 / np.sqrt(10.0))
        two = float(np.float32(2 * (1.0 / np.sqrt(10.0))))

        def axis(a):
            return torch.sign(a) * torch.where(a.abs() > two, 3.0, 1.0)
    else:
        lv = _LV64

        def axis(a):
            m = a.abs() / device_plan(_LV64, a.device)
            return torch.sign(a) * torch.where(
                m > 6, 7.0, torch.where(m > 4, 5.0,
                                        torch.where(m > 2, 3.0, 1.0)))
    return torch.complex(axis(x.real) * lv, axis(x.imag) * lv)


@functools.lru_cache(maxsize=None)
def _dd_smoother_cached(n_rb: int, normal_cp: bool, n0: float,
                        cnt_key: tuple, prior_key):
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp)
    taps = np.arange(fp.cp + 2)
    Fd = np.exp(-2j * np.pi * _signed_freq_idx(fp, np.arange(fp.n_sc))[:, None]
                * taps[None, :] / fp.n_fft)
    P = (_delay_prior(fp) if prior_key is None
         else np.asarray(prior_key, float))
    Rhh = (Fd * P) @ Fd.conj().T
    cnt = np.asarray(cnt_key, float)
    A = Rhh + np.diag(n0 / np.maximum(cnt, 1e-6))
    W = Rhh @ np.linalg.inv(A)
    post = float(np.sum(P)) - np.einsum("kp,kp->k", W, Rhh.conj()).real
    return (np.stack([W.real, W.imag], -1).astype(np.float32),
            np.maximum(post, 0.0).astype(np.float32))


def make_dd_smoother(gm: GridMap, n0: float, prior=None):
    """-> (W [n_sc, n_sc, 2] float32 re/im-packed MMSE smoother over the
    dense decision-directed LS field, err_var [n_sc] its posterior). The
    number of data REs on each subcarrier sets that subcarrier's LS noise."""
    cnt = np.bincount(gm.data_sc, minlength=gm.fp.n_sc)
    pr = None if prior is None else tuple(np.asarray(prior, float).tolist())
    return _dd_smoother_cached(gm.fp.n_rb, gm.fp.normal_cp, float(n0),
                               tuple(int(c) for c in cnt), pr)


@functools.lru_cache(maxsize=None)
def _dd_positions(gm: GridMap, port: int, device) -> tuple:
    """Flat (symbol, subcarrier) positions in a [nsym * n_sc] field of the
    data REs and of port `port`'s pilots (no two coincide), and the number
    of pilots on each subcarrier [n_sc] float32: the pilots' weight in the
    per-subcarrier sums."""
    n_sc = gm.fp.n_sc
    psym, psc, _, _ = _port_pilot_arrays(gm, port)
    data = gm.data_sym.astype(np.int64) * n_sc + gm.data_sc
    pilot = psym.reshape(-1).astype(np.int64) * n_sc + psc.reshape(-1)
    count = np.bincount(psc.reshape(-1), minlength=n_sc).astype(np.float32)
    return (torch.as_tensor(data, device=device),
            torch.as_tensor(pilot, device=device),
            torch.as_tensor(count, device=device))


def dd_refine(y_data, s_hat, gm: GridMap, smoother, weight=None,
              rgrid=None, port: int = 0):
    """Decision-directed refinement: y_data, s_hat [B, n_data] -> H2
    [B, n_sc], subframe-static like the joint estimator.

    Per subcarrier, ls = sum(w y conj(s)) / sum(w |s|^2) over its data REs
    (w: optional per-RE decision confidence), plus the pilots' LS at full
    weight when `rgrid` is given; then H2 = ls @ smoother^T (`smoother`:
    complex64 [n_sc, n_sc] on the device). The per-subcarrier sums are
    formed by writing each RE's term into its own cell of a [B, nsym, n_sc]
    field and summing over symbols: a fixed order, no atomics."""
    fp = gm.fp
    B, dev = y_data.shape[0], y_data.device
    nsym, n_sc = fp.symbols_per_subframe, fp.n_sc
    data_pos, pilot_pos, pilot_count = _dd_positions(gm, port, dev)
    w = torch.ones_like(y_data.real) if weight is None else weight
    num = y_data.new_zeros(B, nsym * n_sc)
    den = w.new_zeros(B, nsym * n_sc)
    num[:, data_pos] = w * y_data * torch.conj(s_hat)
    den[:, data_pos] = w * s_hat.abs() ** 2
    num = num.reshape(B, nsym, n_sc).sum(dim=1)
    den = den.reshape(B, nsym, n_sc).sum(dim=1)
    if rgrid is not None:
        p = _pilot_tensors(gm, port, dev)
        pls = rgrid[:, p["sym"].reshape(-1), p["bin"].reshape(-1)] \
            * p["ref"].reshape(-1)
        pnum = pls.new_zeros(B, nsym * n_sc)
        pnum[:, pilot_pos] = pls
        num = num + pnum.reshape(B, nsym, n_sc).sum(dim=1)
        den = den + pilot_count
    ls = num / torch.clamp(den, min=1e-9)
    return ls @ smoother.T
