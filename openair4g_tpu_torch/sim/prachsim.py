"""PRACH detection-rate and false-alarm Monte-Carlo (counterpart of
openair4g_tpu/sim/prachsim.py).

    python3 -m openair4g_tpu_torch.sim.prachsim -s -22 -S -8
    python3 -m openair4g_tpu_torch.sim.prachsim --time-domain

Two signal paths:
  * RE-level (the default): detection straight on the N_ZC PRACH bins
    (the big transform is a unitary sample-rate conversion), a delay of
    d ZC samples a linear phase across the bins;
  * time_domain=True: the preamble is generated into the sample stream
    (the big IDFT, repetitions and CP at fs = n_fft 15 kHz), delayed by
    whole samples, given a CFO if set, and detected from the samples.
Preamble formats 0-4 (format 4 has N_ZC = 139) and the restricted
(high-speed) cyclic-shift set. `roc` sweeps the detection threshold
against noise-only occasions.

`trial` takes the preamble index, delay and noise normals of every
trial injected; `step` draws them on the simulator's device.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from ..device import cli_device, resolve_device
from ..phy.prach import (FORMAT_TIMING, N_ZC, N_ZC_F4, _dft, n_preambles,
                         prach_cp_samples, prach_detect,
                         prach_samples_per_seq, prach_time_detect,
                         prach_time_generate, preamble_shifted,
                         restricted_shifts)
from .dlsim import _noise


@dataclass(frozen=True)
class PrachsimConfig:
    root_u: int = 129
    ncs: int = 13              # NCS value (not the config index)
    max_delay: int = 10        # ZC samples (~ cell radius)
    batch: int = 64
    threshold: float = 15.0
    fmt: int = 0               # preamble format 0-4 (4 -> N_ZC = 139)
    high_speed: bool = False   # restricted cyclic-shift set
    time_domain: bool = False  # cross the sample-stream front end
    cfo_hz: float = 0.0        # carrier/Doppler offset on the sample stream
    #   (time_domain only): the high-speed axis the restricted set is for
    n_fft: int = 512           # fs = n_fft * 15 kHz (512 = 5 MHz)
    n_ra_prb: int = 0
    n_rb_ul: int = 25


class Prachsim:
    def __init__(self, cfg: PrachsimConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.n_zc = N_ZC_F4 if cfg.fmt == 4 else N_ZC
        if cfg.high_speed:
            if cfg.fmt == 4:
                raise ValueError("format 4 has no restricted set")
            self.shifts = restricted_shifts(cfg.root_u, cfg.ncs)
            if not self.shifts:
                raise ValueError(f"root {cfg.root_u} has no restricted "
                                 f"shift at NCS {cfg.ncs}")
        else:
            self.shifts = [v * cfg.ncs
                           for v in range(n_preambles(cfg.ncs, self.n_zc))]
        self.npre = len(self.shifts)
        if cfg.max_delay >= (cfg.ncs or self.n_zc):
            raise ValueError("the delay must fit the zero-correlation zone")
        W = _dft(self.n_zc)
        self.pre_f = torch.as_tensor(np.stack([
            (W @ preamble_shifted(cfg.root_u, cv, self.n_zc))
            .astype(np.complex64) for cv in self.shifts]), device=dev)
        self._k = torch.arange(self.n_zc, device=dev)
        # a trial's received length: the burst (CP and repetitions) on the
        # time-domain path, the N_ZC bins at RE level
        self.n_samples = (
            prach_cp_samples(cfg.n_fft, cfg.fmt) + FORMAT_TIMING[cfg.fmt][2]
            * prach_samples_per_seq(cfg.n_fft, cfg.fmt)
            if cfg.time_domain else self.n_zc)

    def _received(self, v, dly, noise_normals, n0, amp: float = 1.0):
        """The received bins (RE level) or samples (time domain) of
        preambles v [B] at delays dly [B] (ZC samples), amp times the
        signal, plus noise."""
        cfg, dev = self.cfg, self.device
        v, dly = v.to(dev, torch.int64), dly.to(dev, torch.int64)
        xf = self.pre_f[v]
        if cfg.time_domain:
            s = prach_time_generate(xf, cfg.n_fft, cfg.fmt, cfg.n_ra_prb,
                                    cfg.n_rb_ul)
            # a delay of dly ZC samples: int32(dly * N / n_zc) samples,
            # the product in float32, as the reference forms it
            spz = np.float32(prach_samples_per_seq(cfg.n_fft, cfg.fmt)
                             / self.n_zc)
            shift = (dly.to(torch.float32) * float(spz)).to(torch.int64)
            L = s.shape[-1]
            idx = torch.remainder(torch.arange(L, device=dev)[None]
                                  - shift[:, None], L)
            s = s.gather(1, idx)
            if cfg.cfo_hz:
                t = torch.arange(L, device=dev) / (cfg.n_fft * 15000.0)
                s = s * torch.exp(2j * np.pi * cfg.cfo_hz * t)
        else:
            s = xf * torch.exp(-2j * np.pi * self._k * dly[:, None]
                               / self.n_zc)
        if amp != 1.0:
            s = amp * s
        return s + _noise(noise_normals, n0, dev)

    def _detect(self, rx, threshold: float):
        cfg = self.cfg
        if cfg.time_domain:
            return prach_time_detect(rx, cfg.n_fft, cfg.fmt, cfg.n_ra_prb,
                                     cfg.n_rb_ul, cfg.root_u, cfg.ncs,
                                     threshold, self.n_zc, self.shifts)
        return prach_detect(rx, cfg.root_u, cfg.ncs, threshold, self.n_zc,
                            self.shifts)

    def trial(self, v, dly, noise_normals, n0):
        """[B] occasions on injected draws: the preamble v [B] in
        [0, npre), its delay dly [B] in [0, max_delay] ZC samples, noise
        normals [B, n_samples, 2]. Returns (det [B]: the sent preamble
        detected; delay_ok [B]: detected at its delay, +-1 ZC sample on
        the time-domain path; n_false [B]: other preambles detected)."""
        n0 = float(np.float32(n0))
        dev = self.device
        v, dly = v.to(dev, torch.int64), dly.to(dev, torch.int64)
        _, delay, det = self._detect(
            self._received(v, dly, noise_normals, n0), self.cfg.threshold)
        det_v = det.gather(1, v[:, None])[:, 0]
        d_v = delay.gather(1, v[:, None])[:, 0]
        n_false = det.sum(dim=1) - det_v.to(torch.int64)
        tol = 1 if self.cfg.time_domain else 0
        return det_v, det_v & ((d_v - dly).abs() <= tol), n_false

    def energies(self, v, dly, noise_normals, n0, signal: bool = True):
        """Per-preamble detection energies [B, npre] of RE-level occasions
        on injected draws; signal=False is the noise-only occasion."""
        rx = self._received(v, dly, noise_normals, float(np.float32(n0)),
                            1.0 if signal else 0.0)
        energy, _, _ = prach_detect(rx, self.cfg.root_u, self.cfg.ncs, 1e9,
                                    self.n_zc, self.shifts)
        return energy

    def draw(self, generator: torch.Generator):
        """One step's preambles, delays and noise normals, on the
        simulator's device."""
        B, dev = self.cfg.batch, self.device
        return (torch.randint(0, self.npre, (B,), generator=generator,
                              device=dev),
                torch.randint(0, self.cfg.max_delay + 1, (B,),
                              generator=generator, device=dev),
                torch.randn(B, self.n_samples, 2, generator=generator,
                            device=dev))

    def step(self, generator: torch.Generator, n0):
        return self.trial(*self.draw(generator), n0)

    def run_snr(self, snr_db: float, n_batches: int = 2, seed: int = 0):
        """snr_db = per-PRACH-bin Es/N0 (the preamble is unit-amplitude per
        bin; the processing gain is 10 log10(N_ZC), about 29 dB)."""
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        det = dok = fa = tot = 0
        for _ in range(n_batches):
            d, dk, nf = self.step(gen, n0)
            det += int(d.sum())
            dok += int(dk.sum())
            fa += int(nf.sum())
            tot += self.cfg.batch
        return dict(snr_db=snr_db, det_rate=det / tot,
                    delay_ok_rate=dok / tot, false_per_trial=fa / tot,
                    trials=tot)

    def roc(self, snr_db: float, thresholds, n_batches: int = 4,
            seed: int = 0):
        """Sweep the detection threshold (RE level): the detection rate at
        `snr_db` against the false-alarm rate on noise-only occasions, the
        energies of one set of draws reused across thresholds. Returns
        [{threshold, det_rate, fa_per_occasion}]."""
        if self.cfg.time_domain:
            raise ValueError("roc runs on the RE-level path")
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        sig_e, noise_e, v_trues = [], [], []
        for _ in range(n_batches):
            v, dly, noise = self.draw(gen)
            sig_e.append(self.energies(v, dly, noise, n0).cpu().numpy())
            noise_e.append(self.energies(v, dly, noise, n0,
                                         signal=False).cpu().numpy())
            v_trues.append(v.cpu().numpy())
        sig_e = np.concatenate(sig_e)
        noise_e = np.concatenate(noise_e)
        v_trues = np.concatenate(v_trues)
        rows = []
        for th in thresholds:
            det = sig_e[np.arange(len(v_trues)), v_trues] > th
            rows.append(dict(threshold=float(th),
                             det_rate=float(det.mean()),
                             fa_per_occasion=float((noise_e > th).sum()
                                                   / len(noise_e))))
        return rows


def main(argv=None):
    p = argparse.ArgumentParser(description="PRACH detection sweep")
    p.add_argument("-s", "--snr0", type=float, default=-22.0)
    p.add_argument("-S", "--snr1", type=float, default=-8.0)
    p.add_argument("--step", type=float, default=2.0)
    p.add_argument("-n", "--batches", type=int, default=2)
    p.add_argument("--ncs", type=int, default=13)
    p.add_argument("--fmt", type=int, default=0)
    p.add_argument("--time-domain", action="store_true")
    p.add_argument("--high-speed", action="store_true")
    p.add_argument("--roc", type=float, default=None,
                   help="run a threshold ROC at this SNR instead")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back)")
    a = p.parse_args(argv)
    cli_device("prachsim", a.device)
    root = 1 if a.fmt == 4 else 129
    ncs = 2 if a.fmt == 4 else a.ncs
    sim = Prachsim(PrachsimConfig(root_u=root, ncs=ncs, fmt=a.fmt,
                                  time_domain=a.time_domain,
                                  high_speed=a.high_speed,
                                  max_delay=min(10, ncs - 1)),
                   device=a.device)
    if a.roc is not None:
        rows = sim.roc(a.roc, np.arange(6.0, 30.0, 1.0))
        for r in rows:
            print(f"th {r['threshold']:5.1f}  det {r['det_rate']:.4f}  "
                  f"fa/occasion {r['fa_per_occasion']:.5f}", flush=True)
        return rows
    rows = []
    for snr in np.arange(a.snr0, a.snr1 + 1e-9, a.step):
        r = sim.run_snr(float(snr), n_batches=a.batches)
        rows.append(r)
        print(f"SNR {snr:6.1f} dB/bin  det {r['det_rate']:.3f}  "
              f"delay_ok {r['delay_ok_rate']:.3f}  "
              f"false/trial {r['false_per_trial']:.4f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
