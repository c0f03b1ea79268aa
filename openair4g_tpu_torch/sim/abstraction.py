"""PHY abstraction: effective-SINR link-to-system mapping (EESM / MIESM)
(counterpart of openair4g_tpu/sim/abstraction.py).

Reference parity: openair1/PHY/LTE_TRANSPORT/dlsch_decoding.c:524
(dlsch_abstraction_EESM) and :573 (MIESM), SIMULATION/TOOLS/abstraction.c
(compute_sinr :190, per-MCS BLER table lookup + coin flip) — the oaisim
abstraction mode that replaces bit-level decoding in system simulation.

EESM:  sinr_eff = -beta * ln( mean_i exp(-sinr_i / beta) )
MIESM: sinr_eff = MI^-1( mean_i MI(sinr_i) ) with the per-Qm mutual
information curve (precomputed numerically on a grid).

The curves and tables are numpy on the host, as in the reference; the
SINR maps and the lookup run in float32 on the tensors' device, with
`interp` following jnp.interp's rule (which differs from np.interp where
the grid has equal neighbours, as the saturated MI curve has at its top).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device


def eesm(sinrs, beta: float):
    """sinrs [.., N] linear -> effective SINR [..] (linear)."""
    s = torch.mean(torch.exp(-sinrs / beta), dim=-1)
    return -beta * torch.log(torch.clamp(s, min=1e-30))


def interp(x, xp, fp, left=None, right=None):
    """jnp.interp on float32 tensors: the segment of x is
    searchsorted(xp, x, side='right') clipped to [1, len - 1], so x equal
    to a run of equal grid points takes the run's last segment, and a
    zero-width segment gives its left value (np.interp gives the right
    one). x below xp[0] gives `left` (fp[0]), above xp[-1] `right`
    (fp[-1]). The same float32 operations as jnp.interp on the CPU."""
    n = xp.shape[0]
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, n - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx = xp[i] - x0
    df = fp[i] - f0
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    # f0 + q df as one fused multiply-add, as XLA contracts it on the CPU
    q = (x - x0) / torch.where(dx0, torch.ones_like(dx), dx)
    f = torch.where(dx0, f0, torch.addcmul(f0, q, df))
    f = torch.where(x < xp[0], fp[0] if left is None else
                    float(np.float32(left)), f)
    return torch.where(x > xp[-1], fp[-1] if right is None else
                       float(np.float32(right)), f)


@functools.lru_cache(maxsize=None)
def _mi_grid(Qm: int):
    """Numeric per-symbol mutual information MI(snr) for a Qm-QAM
    constellation, Monte-Carlo on a fixed grid (host precompute)."""
    from ..tables.modulation import mod_table
    pts = mod_table(Qm).astype(np.complex128)
    snr_db = np.linspace(-20.0, 30.0, 101)
    rng = np.random.default_rng(0)
    n_mc = 512
    noise = (rng.normal(size=n_mc) + 1j * rng.normal(size=n_mc)) / np.sqrt(2)
    mi = np.zeros_like(snr_db)
    M = len(pts)
    for i, sdb in enumerate(snr_db):
        snr = 10 ** (sdb / 10)
        sigma = np.sqrt(1.0 / snr)
        acc = 0.0
        for x in pts[: M]:
            y = x + sigma * noise
            d = np.abs(y[:, None] - pts[None, :]) ** 2
            num = np.exp(-(np.abs(y - x) ** 2) / sigma ** 2)
            den = np.exp(-d / sigma ** 2).sum(axis=1)
            acc += np.mean(np.log2(M * num / np.maximum(den, 1e-300)))
        mi[i] = max(acc / M, 0.0)
    return snr_db, mi


@functools.lru_cache(maxsize=None)
def _mi_tensors(Qm: int, device) -> tuple:
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in _mi_grid(Qm))


def miesm(sinrs, Qm: int):
    """Mutual-information ESM: sinr_eff [..] linear."""
    g_db, g_mi = _mi_tensors(Qm, sinrs.device)
    sdb = 10.0 * torch.log10(torch.clamp(sinrs, min=1e-30))
    mi = interp(sdb, g_db, g_mi)
    mi_bar = torch.mean(mi, dim=-1)
    # invert the (monotone) MI curve
    eff_db = interp(mi_bar, g_mi, g_db)
    return 10.0 ** (eff_db / 10.0)


class BlerTable:
    """Per-MCS AWGN BLER curve with log-linear interpolation."""

    def __init__(self, snr_db: np.ndarray, bler: np.ndarray):
        order = np.argsort(snr_db)
        self.snr_db = np.asarray(snr_db, np.float64)[order]
        b = np.clip(np.asarray(bler, np.float64)[order], 1e-6, 1.0)
        self.log_bler = np.log(b)
        self._on: dict = {}

    def lookup(self, sinr_eff):
        """BLER [..] at the effective SINRs [..] (linear), float32 on
        their device."""
        dev = sinr_eff.device
        if dev not in self._on:
            self._on[dev] = tuple(
                torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in (self.snr_db, self.log_bler))
        g_db, g_lb = self._on[dev]
        sdb = 10.0 * torch.log10(torch.clamp(sinr_eff, min=1e-30))
        lb = interp(sdb, g_db, g_lb, left=0.0, right=self.log_bler[-1])
        return torch.exp(lb)


def draw_block_errors(u, bler):
    """Coin-flip block errors from per-trial BLER [..] (abstraction.c's
    uniform draw). `u`: the uniforms [..] of bler's shape, or a
    torch.Generator on bler's device to draw them from."""
    if isinstance(u, torch.Generator):
        u = torch.rand(bler.shape, generator=u, device=bler.device)
    return u.to(bler.device) < bler


def calibrate_bler_table(sim, snrs, n_frames: int, seed: int = 0
                         ) -> BlerTable:
    """Run the bit-level sim once to produce the abstraction's BLER table —
    the reference's AWGN_results corpus generation flow."""
    rows = []
    for s in snrs:
        errs, trials = sim.run_snr(float(s), n_frames, seed)
        e = np.atleast_1d(np.asarray(errs))[0]
        t = np.atleast_1d(np.asarray(trials))[0]
        rows.append((float(s), e / max(t, 1)))
    arr = np.asarray(rows)
    return BlerTable(arr[:, 0], arr[:, 1])


def calibrate_eesm_beta(mcs: int, channel: str = "EVA", n_rb: int = 6,
                        snrs=None, n_frames: int = 256,
                        betas=None, seed: int = 0, n_realizations: int = 2048,
                        awgn_table: "BlerTable | None" = None,
                        device=None) -> dict:
    """Per-(MCS, channel) EESM beta calibration — the counterpart of the
    reference's beta1_dlsch/beta2_dlsch tables (dlsch_decoding.c:543-553),
    regenerated from THIS framework's own link-level sims instead of
    copying the reference's calibration data.

    Method: (1) measure fading BLER with the bit-level sim at `snrs`;
    (2) for each candidate beta, predict the fading BLER as the ensemble
    average of AWGN-table lookups at EESM-effective SINRs over fresh
    channel realizations; (3) pick the beta minimizing the squared
    log-BLER error. Returns dict(beta, measured, predicted, betas, errs).
    The sims run on `device` (None: the card), and the realizations are
    drawn there from a generator seeded with seed + 1.
    """
    from ..config import FrameParms
    from ..tables.tbs import get_Qm
    from .dlsim import DlsimFading, DlsimFadingConfig
    from .channels import ChannelModel
    from .oaisim import calibrated_bler_table

    dev = resolve_device(device)
    qm = get_Qm(mcs)
    if betas is None:
        betas = {2: (0.6, 1.0, 1.6, 2.5, 4.0),
                 4: (2.0, 3.5, 5.0, 7.0, 10.0),
                 6: (8.0, 12.0, 18.0, 27.0, 40.0)}[qm]
    table = awgn_table or calibrated_bler_table(
        mcs, n_rb=n_rb, n_frames=n_frames, device=dev)
    sim = DlsimFading(DlsimFadingConfig(
        mcs=mcs, n_rb=n_rb, channel=channel, n_harq_rounds=1,
        batch=min(n_frames, 128), perfect_ce=True), dev)
    if snrs is None:
        knee = float(np.interp(np.log(0.5), table.log_bler[::-1],
                               table.snr_db[::-1]))
        snrs = (knee, knee + 1.5, knee + 3.0)
    measured = []
    for s in snrs:
        e, r = sim.run_snr(float(s), n_frames, seed)
        measured.append(e[0] / max(r[0], 1))
    # channel realizations -> per-subcarrier SINR ensembles
    fp = FrameParms(n_rb=n_rb)
    cm = ChannelModel(name=channel, fp=fp)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    H = cm.freq_response(cm.draw_taps(n_realizations, generator=gen,
                                      device=dev))
    g = (H.abs() ** 2).cpu().numpy()                    # [R, n_sc]
    errs = []
    for beta in betas:
        pred_err = 0.0
        for s, m in zip(snrs, measured):
            snr_lin = 10.0 ** (float(s) / 10.0)
            eff = eesm(torch.as_tensor(g * snr_lin, dtype=torch.float32,
                                       device=dev), float(beta)).cpu().numpy()
            pred = float(np.mean(np.exp(np.interp(
                10 * np.log10(np.maximum(eff, 1e-30)),
                table.snr_db, table.log_bler,
                left=0.0, right=table.log_bler[-1]))))
            pred_err += (np.log(max(pred, 1e-4))
                         - np.log(max(m, 1e-4))) ** 2
        errs.append(pred_err)
    best = int(np.argmin(errs))
    if best == len(betas) - 1:        # grid edge: extend geometrically once
        extra = [betas[-1] * r for r in (1.6, 2.6, 4.2)]
        more = calibrate_eesm_beta(mcs, channel, n_rb, snrs, n_frames,
                                   betas=tuple(extra), seed=seed,
                                   n_realizations=n_realizations,
                                   awgn_table=table, device=dev)
        if min(more["errs"]) < errs[best]:
            return more
    return dict(beta=float(betas[best]), betas=list(betas),
                errs=[float(e) for e in errs],
                measured=[float(m) for m in measured],
                snrs=[float(s) for s in snrs])
