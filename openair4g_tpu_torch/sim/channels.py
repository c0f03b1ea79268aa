"""Fading channel catalog (counterpart of openair4g_tpu/sim/channels.py):
the 36.101 Annex B and 25.814 SCM tap profiles, Ricean LOS and antenna
correlation, AR(1) fades across HARQ rounds, the time-domain FIR path and
per-OFDM-symbol Jakes trajectories.

Under the cyclic prefix a time-invariant multipath channel is a
per-subcarrier gain H(k) = sum_t a_t exp(-j 2 pi f_k tau_t): one matmul of
the taps with a static phase matrix, then one multiply on the grid. Beyond
the CP only the time-domain path (`apply_channel_time`) carries the
inter-symbol interference. Tap draws take injected standard normals, or
draw them from a torch.Generator; the static matrices live on the device
once per (model, device).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..device import device_plan

# 36.101 Annex B.2 tap profiles: (delays us, powers dB).
_SCM_C_DELAYS = (0, 0.0125, 0.0250, 0.3625, 0.3750, 0.3875, 0.2500, 0.2625,
                 0.2750, 1.0375, 1.0500, 1.0625, 2.7250, 2.7375, 2.7500,
                 4.6000, 4.6125, 4.6250)
_SCM_C_AMPS_DB = (0.00, -2.22, -3.98, -1.86, -4.08, -5.84, -1.08, -3.30,
                  -5.06, -9.08, -11.30, -13.06, -15.14, -17.36, -19.12,
                  -20.64, -22.85, -24.62)
# Rayleigh8/Rice8: linear amplitudes (sum ~1) at uniform delays i*0.1 us.
_RAYLEIGH8_AMPS_LIN = (0.3868472, 0.3094778, 0.1547389, 0.0773694,
                       0.0386847, 0.0193424, 0.0096712, 0.0038685)
_RAYLEIGH8_DELAYS = tuple(0.1 * i for i in range(8))

PROFILES = {
    "EPA": ((0, .03, .07, .09, .11, .19, .41),
            (0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8)),
    "EVA": ((0, .03, .15, .31, .37, .71, 1.09, 1.73, 2.51),
            (0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9)),
    "ETU": ((0, .05, .12, .2, .23, .5, 1.6, 2.3, 5.0),
            (-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0)),
    "SCM_C": (_SCM_C_DELAYS, _SCM_C_AMPS_DB),
    "SCM_D": (_SCM_C_DELAYS, _SCM_C_AMPS_DB),   # SCM-C taps + Rice factor
    "Rayleigh1": ((0.0,), (0.0,)),
    "Rayleigh1_corr": ((0.0,), (0.0,)),
    "Rayleigh1_anticorr": ((0.0,), (0.0,)),
    "Rice1": ((0.0,), (0.0,)),
    "AWGN": ((0.0,), (0.0,)),
    "Rayleigh8": (_RAYLEIGH8_DELAYS, _RAYLEIGH8_AMPS_LIN),
    "Rice8": (_RAYLEIGH8_DELAYS, _RAYLEIGH8_AMPS_LIN),
}

# Models whose power column is linear amplitude, not dB.
_LINEAR_AMP_MODELS = {"Rayleigh8", "Rice8"}

# (scattered-power fraction K_s, angle of arrival, random AoA per trial).
_RICEAN = {"Rice1": (0.1, 0.03, True), "Rice8": (0.1, 0.03, True),
           "SCM_D": (0.1, 0.0, False)}

# Antenna-correlation square roots, row-major [A, A] with A = n_tx*n_rx and
# vec index tx*n_rx + rx: one matrix for the Rayleigh1 variants, one per
# 3-tap group for SCM (scm_corrmat.h).
_SQ2 = 0.70711
R_SQRT_22_CORR = np.array(
    [[_SQ2, 0, _SQ2, 0], [0, _SQ2, 0, _SQ2],
     [_SQ2, 0, _SQ2, 0], [0, _SQ2, 0, _SQ2]], np.complex64)
R_SQRT_22_ANTICORR = np.array(
    [[_SQ2, 0, -_SQ2, 0], [0, _SQ2, 0, -_SQ2],
     [-_SQ2, 0, _SQ2, 0], [0, -_SQ2, 0, _SQ2]], np.complex64)
R_SQRT_21_CORR = np.full((2, 2), _SQ2, np.complex64)
R_SQRT_21_ANTICORR = np.array([[_SQ2, -_SQ2], [-_SQ2, _SQ2]], np.complex64)


def _c(rows, a):
    """Interleaved (re, im) row list -> [n, A, A] complex64."""
    arr = np.asarray(rows, np.float64)
    cx = arr[:, 0::2] + 1j * arr[:, 1::2]
    return cx.reshape(len(rows), a, a).astype(np.complex64)


R22_SQRT = _c([
    [0.921700, -0.000000, 0.010380, -0.027448, -0.250153, 0.294754, 0.005961, 0.010769, 0.010380, 0.027448, 0.921700, 0.000000, -0.011595, -0.004130, -0.250153, 0.294754, -0.250153, -0.294754, -0.011595, 0.004130, 0.921700, 0.000000, 0.010380, -0.027448, 0.005961, -0.010769, -0.250153, -0.294754, 0.010380, 0.027448, 0.921700, 0.000000],
    [0.923810, 0.000000, 0.004069, 0.027832, 0.151730, 0.350180, -0.009882, 0.006114, 0.004069, -0.027832, 0.923810, 0.000000, 0.011218, -0.003029, 0.151730, 0.350180, 0.151730, -0.350180, 0.011218, 0.003029, 0.923810, -0.000000, 0.004069, 0.027832, -0.009882, -0.006114, 0.151730, -0.350180, 0.004069, -0.027832, 0.923810, 0.000000],
    [0.927613, 0.000000, 0.014253, 0.025767, -0.061171, -0.367133, 0.009258, -0.007340, 0.014253, -0.025767, 0.927613, -0.000000, -0.011138, -0.003942, -0.061171, -0.367133, -0.061171, 0.367133, -0.011138, 0.003942, 0.927613, 0.000000, 0.014253, 0.025767, 0.009258, 0.007340, -0.061171, 0.367133, 0.014253, -0.025767, 0.927613, 0.000000],
    [0.869794, -0.000000, -0.010613, -0.001218, 0.399115, 0.289852, -0.004464, -0.004096, -0.010613, 0.001218, 0.869794, -0.000000, -0.005276, -0.002978, 0.399115, 0.289852, 0.399115, -0.289852, -0.005276, 0.002978, 0.869794, -0.000000, -0.010613, -0.001218, -0.004464, 0.004096, 0.399115, -0.289852, -0.010613, 0.001218, 0.869794, 0.000000],
    [0.919726, -0.000000, 0.038700, -0.111146, 0.217804, 0.300925, 0.045531, -0.013659, 0.038700, 0.111146, 0.919726, 0.000000, -0.027201, 0.038983, 0.217804, 0.300925, 0.217804, -0.300925, -0.027201, -0.038983, 0.919726, 0.000000, 0.038700, -0.111146, 0.045531, 0.013659, 0.217804, -0.300925, 0.038700, 0.111146, 0.919726, 0.000000],
    [0.867608, -0.000000, 0.194097, -0.112414, -0.418811, 0.095938, -0.081264, 0.075727, 0.194097, 0.112414, 0.867608, -0.000000, -0.106125, -0.032801, -0.418811, 0.095938, -0.418811, -0.095938, -0.106125, 0.032801, 0.867608, 0.000000, 0.194097, -0.112414, -0.081264, -0.075727, -0.418811, -0.095938, 0.194097, 0.112414, 0.867608, 0.000000],
], 4)
R21_SQRT = _c([
    [0.922167, 0.000000, -0.250280, 0.294903, -0.250280, -0.294903, 0.922167, 0.000000],
    [0.924238, 0.000000, 0.151801, 0.350342, 0.151801, -0.350342, 0.924238, 0.000000],
    [0.928080, 0.000000, -0.061202, -0.367318, -0.061202, 0.367318, 0.928080, 0.000000],
    [0.869860, 0.000000, 0.399145, 0.289874, 0.399145, -0.289874, 0.869860, 0.000000],
    [0.927225, 0.000000, 0.219580, 0.303378, 0.219580, -0.303378, 0.927225, 0.000000],
    [0.896133, 0.000000, -0.432581, 0.099092, -0.432581, -0.099092, 0.896133, 0.000000],
], 2)
R12_SQRT = _c([
    [0.999494, 0.000000, 0.011256, -0.029765, 0.011256, 0.029765, 0.999494, 0.000000],
    [0.999537, 0.000000, 0.004402, 0.030114, 0.004402, -0.030114, 0.999537, 0.000000],
    [0.999497, 0.000000, 0.015358, 0.027764, 0.015358, -0.027764, 0.999497, 0.000000],
    [0.999925, -0.000000, -0.012201, -0.001400, -0.012201, 0.001400, 0.999925, 0.000000],
    [0.991912, 0.000000, 0.041738, -0.119870, 0.041738, 0.119870, 0.991912, 0.000000],
    [0.968169, 0.000000, 0.216594, -0.125443, 0.216594, 0.125443, 0.968169, 0.000000],
], 2)


def bessel_j0(x) -> np.ndarray:
    """J0 via its integral form (host-side, for Doppler correlations)."""
    th = np.linspace(0.0, np.pi, 2001)
    return np.trapezoid(np.cos(np.asarray(x)[..., None] * np.sin(th)),
                        th, axis=-1) / np.pi


def jakes_rho(doppler_hz: float, dt_s: float) -> float:
    """Fade autocorrelation over dt under the Jakes spectrum."""
    return float(bessel_j0(2.0 * np.pi * doppler_hz * dt_s))


def harq_forgetting_factor(doppler_hz: float, dt_s: float = 8e-3) -> float:
    """AR(1) forgetting factor giving the Jakes correlation at the HARQ RTT:
    evolve_taps correlates consecutive draws by sqrt(ff), so ff = rho^2
    (a negative rho, past the first Jakes null, is clamped to iid)."""
    return max(jakes_rho(doppler_hz, dt_s), 0.0) ** 2


def _signed_sc(fp: FrameParms) -> np.ndarray:
    """Signed subcarrier index of each occupied subcarrier (DC skipped)."""
    k = np.arange(fp.n_sc)
    half = 6 * fp.n_rb
    return np.where(k < half, k - half, k - half + 1)


@dataclass(frozen=True)
class ChannelModel:
    """Tap-delay-line channel of one PROFILES entry, per (RX, TX) pair."""
    name: str                 # key into PROFILES
    fp: FrameParms
    n_tx: int = 1
    n_rx: int = 1
    delay_scale: float = 1.0  # multiplies every tap delay (0.651 reproduces
    #                           the reference corpus' compressed spread)

    def __post_init__(self):
        if self.name not in PROFILES:
            raise ValueError(f"ChannelModel({self.name!r}): not one of "
                             f"{sorted(PROFILES)}")

    @property
    def n_taps(self) -> int:
        return len(PROFILES[self.name][0])

    @functools.cached_property
    def amps(self) -> np.ndarray:
        """Per-tap linear powers, normalized to sum 1."""
        a = np.asarray(PROFILES[self.name][1], np.float64)
        if self.name not in _LINEAR_AMP_MODELS:
            a = 10.0 ** (0.1 * a)
        return (a / a.sum()).astype(np.float32)

    @property
    def ricean(self):
        """(scattered fraction K_s, aoa, random_aoa); (1, 0, False) is pure
        Rayleigh."""
        return _RICEAN.get(self.name, (1.0, 0.0, False))

    @functools.cached_property
    def r_sqrt_stack(self) -> np.ndarray | None:
        """[T, A, A] antenna-correlation square roots, or None."""
        pair = (self.n_tx, self.n_rx)
        if self.n_tx * self.n_rx == 1:
            return None
        if self.name in ("SCM_C", "SCM_D"):
            base = {(2, 2): R22_SQRT, (2, 1): R21_SQRT,
                    (1, 2): R12_SQRT}.get(pair)
            return None if base is None else base[np.arange(self.n_taps) // 3]
        if self.name.endswith("_corr") or self.name.endswith("_anticorr"):
            anti = self.name.endswith("_anticorr")
            m = {(2, 2): R_SQRT_22_ANTICORR if anti else R_SQRT_22_CORR,
                 (2, 1): R_SQRT_21_ANTICORR if anti else R_SQRT_21_CORR
                 }.get(pair)
            return None if m is None else m[None].repeat(self.n_taps, axis=0)
        return None

    @functools.cached_property
    def phase_matrix(self) -> np.ndarray:
        """[T, n_sc] complex64: exp(-j 2 pi f_k tau_t) at occupied SCs."""
        f_hz = _signed_sc(self.fp).astype(np.float64) * 15000.0
        tau = np.asarray(PROFILES[self.name][0])[:, None] * 1e-6 \
            * self.delay_scale
        return np.exp(-2j * np.pi * f_hz[None, :] * tau).astype(np.complex64)

    @functools.lru_cache(maxsize=None)
    def tensors(self, device) -> dict:
        """The model's static matrices on `device`, uploaded once."""
        def t(a):
            return None if a is None else torch.as_tensor(a, device=device)
        return {"amps": t(self.amps), "phase": t(self.phase_matrix),
                "r_sqrt": t(self.r_sqrt_stack)}

    def draw_normals(self, batch: int, generator=None, device=None):
        """The standard normals one draw_taps call takes, drawn from
        `generator` on `device`: None for AWGN (no draw); [B, n_rx, n_tx,
        T, 2]; and for the random-AoA models (Rice1, Rice8) the pair of
        that and the AoA normals [B]."""
        if self.name == "AWGN":
            return None
        n = torch.randn(batch, self.n_rx, self.n_tx, self.n_taps, 2,
                        generator=generator, device=device)
        if self.ricean[2]:
            return n, torch.randn(batch, generator=generator, device=device)
        return n

    def draw_taps(self, batch: int, normals=None, generator=None,
                  device=None):
        """Taps with E sum_t |a_t|^2 = 1 per antenna pair: [B, T] complex64
        for a 1x1 model, [B, n_rx, n_tx, T] otherwise. The scattered part is
        complex Gaussian scaled by sqrt(K_s amps / 2); Ricean models add the
        LOS plane wave sqrt(1 - K_s) exp(j pi (rx - tx) sin(aoa)) on tap 0
        (aoa uniform per trial from the AoA normal for Rice1/Rice8, whose
        1x1 LOS needs none); correlated models multiply the antenna vector
        by R_sqrt. `normals` is what draw_normals returns (moved to
        `device` when one is given); without it the normals are drawn from
        `generator` on `device`."""
        T, ntx, nrx = self.n_taps, self.n_tx, self.n_rx
        if self.name == "AWGN":
            shape = (batch, 1) if ntx == nrx == 1 else (batch, nrx, ntx, 1)
            return torch.ones(shape, dtype=torch.complex64, device=device)
        if normals is None:
            normals = self.draw_normals(batch, generator, device)
        elif device is not None:
            normals = (tuple(n.to(device) for n in normals)
                       if isinstance(normals, tuple) else normals.to(device))
        aoa = None
        if isinstance(normals, tuple):
            normals, aoa = normals
        shape = (batch, nrx, ntx, T, 2)
        if tuple(normals.shape) != shape:
            raise ValueError(f"normals {tuple(normals.shape)} != {shape}")
        dev = normals.device
        plan = self.tensors(dev)
        k_s, aoa_fixed, random_aoa = self.ricean
        scale = torch.sqrt(k_s * plan["amps"] / 2.0)
        n = normals.to(torch.float32)
        a = torch.complex(scale * n[..., 0], scale * n[..., 1])
        if k_s != 1.0:
            d = (torch.arange(nrx, device=dev)[:, None]
                 - torch.arange(ntx, device=dev)[None, :]).to(torch.float32)
            if random_aoa:
                if aoa is None:
                    if ntx * nrx > 1:
                        raise ValueError(f"{self.name} {nrx}x{ntx}: the "
                                         "AoA normals are needed")
                    aoa = torch.zeros(batch, device=dev)
                u = aoa.to(dev, torch.float32)
                ang = 2.0 * np.pi * (0.5 * (1.0 + torch.erf(
                    u / np.sqrt(2.0))))
                sin_aoa = torch.sin(ang)[:, None, None]
            else:
                sin_aoa = float(np.float32(np.sin(aoa_fixed)))
            x = np.pi * d * sin_aoa
            los = float(np.sqrt(np.float32(1.0 - k_s))) * torch.exp(
                torch.complex(torch.zeros_like(x), x))
            a[..., 0] += los
        rs = plan["r_sqrt"]
        if rs is not None:
            v = a.permute(0, 3, 2, 1).reshape(batch, T, ntx * nrx)
            v = torch.einsum("tij,btj->bti", rs, v)
            a = v.reshape(batch, T, ntx, nrx).permute(0, 3, 2, 1)
        return a[:, 0, 0] if ntx == nrx == 1 else a

    def evolve_taps(self, a_prev, normals, ff: float):
        """AR(1) fade a = sqrt(ff) a_prev + sqrt(1 - ff) a_new, with a_new
        drawn by draw_taps from `normals`: consecutive draws correlate by
        sqrt(ff) (harq_forgetting_factor gives the Jakes-matched ff)."""
        a_new = self.draw_taps(a_prev.shape[0], normals=normals,
                               device=a_prev.device)
        return (float(np.sqrt(ff)) * a_prev
                + float(np.sqrt(1.0 - ff)) * a_new).to(torch.complex64)

    def freq_response(self, taps):
        """taps [..., T] -> H [..., n_sc] at the occupied subcarriers."""
        if self.name == "AWGN":
            return torch.ones(taps.shape[:-1] + (self.fp.n_sc,),
                              dtype=torch.complex64, device=taps.device)
        return taps @ self.tensors(taps.device)["phase"]

    def freq_response_at(self, taps, f_idx: tuple):
        """taps [..., T] -> H [..., len(f_idx)] at signed subcarrier indices
        (an uplink allocation has no DC skip, so its caller names them)."""
        if self.name == "AWGN":
            return torch.ones(taps.shape[:-1] + (len(f_idx),),
                              dtype=torch.complex64, device=taps.device)
        return taps @ device_plan(self._phase_matrix_at(f_idx), taps.device)

    @functools.lru_cache(maxsize=None)
    def _phase_matrix_at(self, f_idx: tuple) -> np.ndarray:
        delays_us, _ = PROFILES[self.name]
        f_hz = np.asarray(f_idx, np.float64) * 15000.0
        tau = np.asarray(delays_us)[:, None] * 1e-6 * self.delay_scale
        return np.exp(-2j * np.pi * f_hz[None, :] * tau).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _sc_bins(fp: FrameParms, device) -> torch.Tensor:
    """FFT bin of each occupied subcarrier, on `device`."""
    return torch.as_tensor(fp.sc_to_bin(np.arange(fp.n_sc)),
                           dtype=torch.long, device=device)


def apply_channel_grid(grid, H, fp: FrameParms):
    """grid [B, nsym, n_fft] x H [B, n_sc] -> faded grid (exact under CP)."""
    mult = torch.zeros(H.shape[0], fp.n_fft, dtype=H.dtype, device=H.device)
    mult[:, _sc_bins(fp, H.device)] = H
    return grid * mult[:, None, :]


def apply_channel_bins(grid, H, bins: np.ndarray, n_fft: int):
    """grid [B, nsym, n_fft] x H [B, len(bins)] at explicit FFT bins (a
    static plan, uploaded once)."""
    mult = torch.zeros(H.shape[0], n_fft, dtype=H.dtype, device=H.device)
    mult[:, device_plan(bins, H.device, dtype=torch.long)] = H
    return grid * mult[:, None, :]


# ----------------------------------------------------- time-domain path --

FIR_PRE_RING = 8     # bulk delay giving the sinc placement room for its
#                      pre-ringing (the reference's NB_SAMPLES_CHANNEL_OFFSET)


def _fir_sinc_matrix(cm: ChannelModel) -> np.ndarray:
    """[L_ch, T] band-limited placement of each tap at its fractional
    sample delay (plus FIR_PRE_RING)."""
    delays_us, _ = PROFILES[cm.name]
    fs = cm.fp.n_fft * 15000.0
    d = np.asarray(delays_us, np.float64) * 1e-6 * cm.delay_scale * fs \
        + FIR_PRE_RING
    L_ch = int(np.ceil(d.max())) + FIR_PRE_RING + 1
    k = np.arange(L_ch)
    return np.sinc(k[:, None] - d[None, :])


@functools.lru_cache(maxsize=None)
def _fir_tensors(cm: ChannelModel, device) -> tuple:
    """(sinc matrix^T [T, L_ch], FIR-to-subcarrier DFT^T [L_ch, n_sc]) as
    complex64 on `device`; the DFT removes the FIR_PRE_RING bulk delay."""
    S = _fir_sinc_matrix(cm)
    k = np.arange(S.shape[0]) - FIR_PRE_RING
    F = np.exp(-2j * np.pi * _signed_sc(cm.fp)[:, None] * k[None, :]
               / cm.fp.n_fft)
    return (torch.as_tensor(S.T.astype(np.complex64), device=device),
            torch.as_tensor(F.T.astype(np.complex64), device=device))


def _fir_from_taps(cm: ChannelModel, taps):
    """taps [..., T] -> FIR [..., L_ch]: sum_l sinc(k - d_l) a_l."""
    return taps @ _fir_tensors(cm, taps.device)[0]


def fir_freq_response(cm: ChannelModel, taps):
    """The truncated FIR's exact response at the occupied subcarriers with
    the FIR_PRE_RING bulk delay removed (apply_channel_time compensates it
    at the receive window): the genie-CE counterpart of apply_channel_time."""
    return _fir_from_taps(cm, taps) @ _fir_tensors(cm, taps.device)[1]


def apply_channel_time(t, cm: ChannelModel, taps):
    """Linear FIR convolution of the subframe sample stream (the reference's
    multipath_channel) by FFTs of length S + L, with the receive window
    moved FIR_PRE_RING samples in and the tail beyond the subframe dropped.
    t [B, S] complex64, taps [B, T] -> [B, S]."""
    if cm.name == "AWGN":
        return t
    fir = _fir_from_taps(cm, taps)
    S = t.shape[1]
    n = S + fir.shape[-1]
    y = torch.fft.ifft(torch.fft.fft(t, n=n, dim=-1)
                       * torch.fft.fft(fir, n=n, dim=-1), dim=-1)
    return y[:, FIR_PRE_RING:FIR_PRE_RING + S].to(torch.complex64)


# ----------------------------------------- intra-subframe Doppler fade --

def symbol_center_times(fp: FrameParms) -> np.ndarray:
    """[nsym] center time (seconds) of each OFDM symbol in a subframe."""
    fs = fp.sample_rate_hz
    t, pos = [], 0
    for s in range(fp.symbols_per_subframe):
        cp = fp.cp0 if (s % fp.symbols_per_slot) == 0 else fp.cp
        t.append((pos + cp + fp.n_fft / 2) / fs)
        pos += cp + fp.n_fft
    return np.asarray(t)


@functools.lru_cache(maxsize=None)
def jakes_symbol_corr_sqrt(n_rb: int, doppler_hz: float,
                           normal_cp: bool = True) -> np.ndarray:
    """[nsym, nsym] Cholesky factor of R[i, j] = J0(2 pi fd |t_i - t_j|)
    over the symbol centers."""
    fp = FrameParms(n_rb=n_rb, normal_cp=normal_cp)
    t = symbol_center_times(fp)
    r = bessel_j0(2.0 * np.pi * doppler_hz * np.abs(t[:, None] - t[None, :]))
    return np.linalg.cholesky(r + 1e-9 * np.eye(len(t))).astype(np.float32)


def draw_taps_timevar(cm: ChannelModel, batch: int, doppler_hz: float,
                      normals=None, generator=None, device=None):
    """[B, nsym, T] Jakes-correlated tap trajectories of a SISO model on
    `device` from standard normals [B, nsym, T, 2] (injected, or drawn from
    `generator` on `device`); AWGN makes no draw and gives ones
    [B, nsym, 1]."""
    if cm.n_tx != 1 or cm.n_rx != 1:
        raise ValueError("draw_taps_timevar: SISO models only")
    fp = cm.fp
    nsym = fp.symbols_per_subframe
    if cm.name == "AWGN":
        return torch.ones(batch, nsym, 1, dtype=torch.complex64,
                          device=device)
    if normals is None:
        normals = torch.randn(batch, nsym, cm.n_taps, 2, generator=generator,
                              device=device)
    n = normals.to(device, torch.float32)
    g = torch.complex(n[..., 0], n[..., 1])
    g = torch.einsum("su,but->bst", _jakes_tensor(fp, float(doppler_hz),
                                                  n.device), g)
    scale = torch.sqrt(cm.tensors(n.device)["amps"] / 2.0)
    return (scale * g).to(torch.complex64)


@functools.lru_cache(maxsize=None)
def _jakes_tensor(fp: FrameParms, doppler_hz: float, device):
    return torch.as_tensor(jakes_symbol_corr_sqrt(
        fp.n_rb, doppler_hz, fp.normal_cp), device=device).to(torch.complex64)


def apply_channel_grid_timevar(grid, cm: ChannelModel, taps_sym,
                               fp: FrameParms):
    """grid [B, nsym, n_fft] x taps_sym [B, nsym, T] -> (faded grid with a
    different channel on every OFDM symbol, H_sym [B, nsym, n_sc])."""
    H_sym = taps_sym @ cm.tensors(taps_sym.device)["phase"]
    bins = _sc_bins(fp, grid.device)
    out = grid.clone()
    out[:, :, bins] = grid[:, :, bins] * H_sym
    return out, H_sym
