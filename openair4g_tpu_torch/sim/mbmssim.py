"""PMCH/MBSFN link-level BLER simulator (counterpart of
openair4g_tpu/sim/mbmssim.py).

The eNB sends the PMCH over an extended-CP MBSFN subframe; the channel
is the MBSFN composite of n_sfn_cells cells sending the same waveform at
random delays within the extended CP, each an iid Rayleigh ray, so it is
one complex gain a subcarrier per trial; the UE estimates it from the
MBSFN RS (or takes it as known) and decodes the MCH through the DL-SCH
bit chain (phy/pdsch.DlschCodec, the v2 turbo kernel on a card). SNR is
per RE: n0 = 10^(-SNR/10), unit-energy symbols, unitary transforms.

`trial` takes every draw injected (TB bits, the cells' delay uniforms and
amplitude normals, the noise normals); `step` draws them on the
simulator's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gold import gold_sequence, scramble_bits, unscramble_llrs
from ..ops.llr import demap_llr, map_symbols
from ..phy import ofdm
from ..phy.pdsch import DlschCodec, DlschConfig
from ..phy.pmch import (make_mbsfn_map, mbsfn_estimate_channel,
                        mbsfn_fill_grid, pmch_cinit)
from .dlsim import _idx, _noise


@dataclass(frozen=True)
class MbmssimConfig:
    """The reference's MbmssimConfig fields and defaults, plus
    decoder_window (None: 96 on the CPU, 240 on a card)."""
    mcs: int = 4
    n_rb: int = 25
    n_id_mbsfn: int = 0
    subframe: int = 1
    n_sfn_cells: int = 3        # cells in the single-frequency network
    max_delay_frac: float = 0.8  # delays up to this fraction of the ECP
    perfect_ce: bool = False
    n_turbo_iter: int = 8
    batch: int = 64
    decoder_window: int | None = None


class Mbmssim:
    def __init__(self, cfg: MbmssimConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.mm = mm = make_mbsfn_map(cfg.n_rb, cfg.n_id_mbsfn, cfg.subframe)
        self.fp = fp = mm.fp
        Qm = DlschConfig(mcs=cfg.mcs, n_rb=cfg.n_rb).Qm
        self.codec = DlschCodec(DlschConfig(
            mcs=cfg.mcs, n_rb=cfg.n_rb, n_turbo_iter=cfg.n_turbo_iter,
            decoder_window=cfg.decoder_window,
            g_override=mm.n_data_re * Qm))
        self.scr_seq = gold_sequence(
            pmch_cinit(cfg.n_id_mbsfn, cfg.subframe), self.codec.cfg.G)
        # the subcarrier frequencies (for the delay phases) and their bins
        self._f = torch.as_tensor(
            (np.arange(fp.n_sc) - 6 * fp.n_rb).astype(np.float32), device=dev)
        self._bins = _idx(fp.sc_to_bin(np.arange(fp.n_sc)), dev)
        self._ds, self._dc, self._db = (_idx(a, dev) for a in (
            mm.data_sym, mm.data_sc, mm.data_bin))

    def sfn_channel(self, delay_u, amp_normals):
        """The composite channel [B, n_sc]: cell c at delay u_c d_max
        (d_max = max_delay_frac of the extended CP, u_c uniform in [0, 1))
        with gain (a_c + j b_c) / sqrt(2 C) from amp_normals [B, C, 2]."""
        cfg, fp, dev = self.cfg, self.fp, self.device
        delays = delay_u.to(dev, torch.float32) \
            * float(np.float32(cfg.max_delay_frac * fp.cp))
        a = amp_normals.to(dev, torch.float32)
        amps = torch.complex(a[..., 0], a[..., 1]) \
            / float(np.float32(np.sqrt(2 * cfg.n_sfn_cells)))
        phase = torch.exp(-2j * np.pi * delays[..., None] * self._f
                          / fp.n_fft)                     # [B, C, n_sc]
        return torch.sum(amps[..., None] * phase, dim=1)

    def trial(self, tb_bits, delay_u, amp_normals, noise_normals, n0):
        """[B] subframes on injected draws: tb_bits [B, TBS] {0,1},
        delay_u [B, C] uniforms in [0, 1), amp_normals [B, C, 2],
        noise_normals [B, samples_per_tti, 2]. Returns (ok [B] the TB
        decoded, bit_errs [B])."""
        cfg, codec, dev = self.cfg, self.codec, self.device
        B, Qm = tb_bits.shape[0], codec.cfg.Qm
        n0 = float(np.float32(n0))
        tb_bits = tb_bits.to(dev, torch.int32)
        e = scramble_bits(codec.encode(tb_bits), self.scr_seq)
        grid = mbsfn_fill_grid(map_symbols(e, Qm), self.mm)
        H = self.sfn_channel(delay_u, amp_normals)
        grid[:, :, self._bins] = grid[:, :, self._bins] * H[:, None, :]
        rx = ofdm.ofdm_modulate(grid, self.fp) + _noise(noise_normals, n0,
                                                         dev)
        rgrid = ofdm.ofdm_demodulate(rx, self.fp)
        if cfg.perfect_ce:
            h = H[:, self._dc]
        else:
            h = mbsfn_estimate_channel(rgrid, self.mm, 1e-2)
        y = rgrid[:, self._ds, self._db]
        g = torch.clamp(h.abs() ** 2, min=1e-9)
        llr = demap_llr(y * torch.conj(h) / g, n0 / g, Qm).reshape(B, -1)
        tb_hat, ok, _ = codec.decode(unscramble_llrs(llr, self.scr_seq))
        return ok, (tb_hat - tb_bits).abs().sum(dim=1)

    def draw(self, generator: torch.Generator):
        """One step's draws for `trial`, on the simulator's device."""
        cfg, dev, B = self.cfg, self.device, self.cfg.batch
        C = cfg.n_sfn_cells
        return (torch.randint(0, 2, (B, self.codec.cfg.tbs),
                              generator=generator, device=dev,
                              dtype=torch.int32),
                torch.rand(B, C, generator=generator, device=dev),
                torch.randn(B, C, 2, generator=generator, device=dev),
                torch.randn(B, self.fp.samples_per_tti, 2,
                            generator=generator, device=dev))

    def step(self, generator: torch.Generator, n0):
        return self.trial(*self.draw(generator), n0)

    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0):
        """Block errors over ceil(n_frames / batch) steps: (errs, trials)."""
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        errs = trials = 0
        for _ in range(-(-n_frames // self.cfg.batch)):
            ok, _ = self.step(gen, n0)
            errs += int((~ok).sum())
            trials += ok.numel()
        return errs, trials

    def sweep(self, snrs, n_frames: int, seed: int = 0, verbose: bool = True,
              early_exit: bool = True):
        """SNR sweep; rows of (snr, errs, trials, bler)."""
        rows = []
        for s in snrs:
            errs, trials = self.run_snr(float(s), n_frames, seed)
            bler = errs / max(trials, 1)
            rows.append((float(s), errs, trials, bler))
            if verbose:
                print(f"SNR {s:+6.2f} dB: bler {bler:.4f} ({errs}/{trials})",
                      flush=True)
            if early_exit and errs == 0:
                break
        return rows
