"""PBCH (MIB) BLER Monte-Carlo over AWGN (counterpart of
openair4g_tpu/sim/pbchsim.py).

    python3 -m openair4g_tpu_torch.sim.pbchsim -B 25 -s -10 -S -2

One step runs [batch] subframe-0 captures: pilots and the PBCH quarter of
frame `frame_phase` -> OFDM -> AWGN -> Wiener channel estimation (or the
genie channel) -> MMSE equalization -> LLRs -> the blind decode over the
4 frame phases and the antenna masks. The transmitted waveform is the
same in every trial, built once.

`trial` takes the noise normals injected; `step` draws them on the
simulator's device.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..convert import wiener_stack_from_reference
from ..device import cli_device, resolve_device
from ..ops.llr import demap_llr
from ..phy import ofdm
from ..phy.channel_est import estimate_channel, make_wiener_stack
from ..phy.pbch import (make_pbch_map, pack_mib, pbch_blind_decode,
                        pbch_frame_symbols)
from ..phy.resource_grid import fill_grid, make_grid_map
from .dlsim import _idx, _noise


@dataclass(frozen=True)
class PbchsimConfig:
    n_rb: int = 25
    n_id_cell: int = 0
    sfn: int = 0
    frame_phase: int = 0
    batch: int = 64
    perfect_ce: bool = False


class Pbchsim:
    def __init__(self, cfg: PbchsimConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        self.mib = pack_mib(cfg.n_rb, cfg.sfn)
        self.pm = pm = make_pbch_map(cfg.n_rb, cfg.n_id_cell)
        # the pilot layout of the PDSCH grid map (subframe 0)
        self.gm = make_grid_map(cfg.n_rb, 1, cfg.n_id_cell, subframe=0)
        self._sym, self._sc, self._bins = (_idx(a, dev)
                                           for a in (pm.sym, pm.sc, pm.bins))
        grid = fill_grid(torch.zeros(1, self.gm.n_data_re,
                                     dtype=torch.complex64, device=dev),
                         self.gm)
        grid[:, self._sym, self._bins] = torch.as_tensor(
            pbch_frame_symbols(self.mib, cfg.n_id_cell, cfg.frame_phase),
            device=dev)
        self.tx = ofdm.ofdm_modulate(grid, self.fp)     # [1, samples]
        self._mib_true = torch.as_tensor(self.mib, device=dev)

    def wiener(self, snr_db: float):
        """The Wiener stack for the 4 pilot symbols' average (noise
        n0 / 4), complex64 on the device."""
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        return wiener_stack_from_reference(
            make_wiener_stack(self.gm, float(n0) / 4.0), self.device)

    def trial(self, noise_normals, n0, W):
        """[B] captures on injected noise normals [B, samples, 2]; W from
        `wiener` (unused with perfect_ce). Returns exact [B] bool: the MIB
        decoded right at the right frame phase."""
        cfg, dev = self.cfg, self.device
        B = noise_normals.shape[0]
        n0 = float(np.float32(n0))
        r = self.tx + _noise(noise_normals, n0, dev)
        rgrid = ofdm.ofdm_demodulate(r, self.fp)
        if cfg.perfect_ce:
            H = torch.ones(B, len(self.pm.sym), dtype=torch.complex64,
                           device=dev)
        else:
            H = estimate_channel(rgrid, self.gm, W, time_avg=True)[
                :, self._sym, self._sc]
        y = rgrid[:, self._sym, self._bins]
        h2 = H.abs() ** 2
        yeq = y * torch.conj(H) / (h2 + n0)
        llr = demap_llr(yeq, n0 / (h2 + 1e-9), 2).reshape(B, 480)
        ok, mib_hat, phase, _ = pbch_blind_decode(llr, cfg.n_id_cell)
        return ok & torch.all(mib_hat == self._mib_true, dim=-1) \
            & (phase == cfg.frame_phase)

    def draw(self, generator: torch.Generator):
        """One step's noise normals, on the simulator's device."""
        return torch.randn(self.cfg.batch, self.tx.shape[1], 2,
                           generator=generator, device=self.device)

    def step(self, generator: torch.Generator, n0, W):
        return self.trial(self.draw(generator), n0, W)

    def run_snr(self, snr_db: float, n_batches: int = 2, seed: int = 0):
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        W = self.wiener(snr_db)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        ok = tot = 0
        for _ in range(n_batches):
            ok += int(self.step(gen, n0, W).sum())
            tot += self.cfg.batch
        return dict(snr_db=snr_db, bler=1.0 - ok / tot, trials=tot)


def main(argv=None):
    p = argparse.ArgumentParser(description="PBCH BLER sweep")
    p.add_argument("-B", "--n-rb", type=int, default=25)
    p.add_argument("-s", "--snr0", type=float, default=-10.0)
    p.add_argument("-S", "--snr1", type=float, default=-2.0)
    p.add_argument("--step", type=float, default=2.0)
    p.add_argument("-n", "--batches", type=int, default=2)
    p.add_argument("-F", "--perfect-ce", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back)")
    a = p.parse_args(argv)
    cli_device("pbchsim", a.device)
    sim = Pbchsim(PbchsimConfig(n_rb=a.n_rb, perfect_ce=a.perfect_ce),
                  device=a.device)
    rows = []
    for snr in np.arange(a.snr0, a.snr1 + 1e-9, a.step):
        r = sim.run_snr(float(snr), n_batches=a.batches)
        rows.append(r)
        print(f"SNR {snr:6.1f} dB  PBCH BLER {r['bler']:.4f} "
              f"({r['trials']} trials)", flush=True)
    return rows


if __name__ == "__main__":
    main()
