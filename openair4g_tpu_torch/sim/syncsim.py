"""Cell-search detection-rate Monte-Carlo (counterpart of
openair4g_tpu/sim/syncsim.py).

    python3 -m openair4g_tpu_torch.sim.syncsim -B 25 -s -12 -S 0

Each step builds [batch] 5 ms captures holding one subframe-0 waveform
(SSS in symbol 5, PSS in symbol 6, FDD normal CP) at a random timing
offset, applies a CFO (if set) and AWGN, runs the batched matched-filter
cell search, and scores the cell ID, the timing and the fractional CFO
estimate. SNR is per sync RE: unit-energy REs and unitary transforms.

`trial` takes the offsets and the noise normals injected; `step` draws
them on the simulator's device.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..device import cli_device, resolve_device
from ..phy import ofdm
from ..phy.sync import (CellSearch, center62_bins, estimate_cfo,
                        pss_sequence, sss_sequence)
from .dlsim import _noise


@dataclass(frozen=True)
class SyncsimConfig:
    n_rb: int = 25
    nid1: int = 0
    nid2: int = 0
    batch: int = 32
    cfo_scs: float = 0.0      # carrier frequency offset in subcarrier spacings


class Syncsim:
    def __init__(self, cfg: SyncsimConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.fp = fp = FrameParms(n_rb=cfg.n_rb,
                                  n_id_cell=3 * cfg.nid1 + cfg.nid2)
        bins = center62_bins(fp)
        grid = np.zeros((1, fp.symbols_per_subframe, fp.n_fft), np.complex64)
        grid[0, 5, bins] = sss_sequence(cfg.nid1, cfg.nid2, False)
        grid[0, 6, bins] = pss_sequence(cfg.nid2)
        self.subframe_t = torch.as_tensor(
            ofdm.ofdm_modulate_host(grid, fp)[0].astype(np.complex64),
            device=dev)
        self.search = CellSearch(fp)
        # where the PSS symbol's useful part begins within the subframe:
        # symbols 0..5, then symbol 6's CP
        self.pss_t0 = (fp.cp0 + fp.n_fft) + 5 * (fp.cp + fp.n_fft) + fp.cp
        self.max_off = self.search.capture_len - fp.samples_per_tti - fp.n_fft

    def trial(self, offsets, noise_normals, n0):
        """[B] captures on injected draws: offsets [B] int in [0, max_off),
        noise_normals [B, capture_len, 2]. Returns (nid_ok [B], pos_err [B]
        detected minus true PSS position, cfo_hat [B] in subcarrier
        spacings)."""
        cfg, fp, dev = self.cfg, self.fp, self.device
        B, L = offsets.shape[0], self.search.capture_len
        n0 = float(np.float32(n0))
        offsets = offsets.to(dev, torch.int64)
        T = self.subframe_t.shape[0]
        cap = torch.zeros(B, L, dtype=torch.complex64, device=dev)
        cap.scatter_(1, offsets[:, None] + torch.arange(T, device=dev),
                     self.subframe_t.expand(B, T))
        if cfg.cfo_scs:
            ph = 2j * np.pi * cfg.cfo_scs / fp.n_fft
            cap = cap * torch.exp(ph * torch.arange(L, device=dev))
        cap = cap + _noise(noise_normals, n0, dev)
        res = self.search.search(cap)
        nid_ok = ((res["nid2"] == cfg.nid2) & (res["nid1"] == cfg.nid1)
                  & (res["half"] == 0))
        pos_err = res["pss_pos"] - (offsets + self.pss_t0)
        cfo = estimate_cfo(cap, res["pss_pos"], res["nid2"], fp.n_fft)
        return nid_ok, pos_err, cfo

    def draw(self, generator: torch.Generator):
        """One step's offsets and noise normals, on the simulator's
        device."""
        B, dev = self.cfg.batch, self.device
        return (torch.randint(0, self.max_off, (B,), generator=generator,
                              device=dev),
                torch.randn(B, self.search.capture_len, 2,
                            generator=generator, device=dev))

    def step(self, generator: torch.Generator, n0):
        return self.trial(*self.draw(generator), n0)

    def run_snr(self, snr_db: float, n_batches: int = 4, seed: int = 0):
        """Detection statistics at one SNR (per sync RE)."""
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        ok = err = tot = 0
        cfo_abs = 0.0
        for _ in range(n_batches):
            nid_ok, pos_err, cfo = self.step(gen, n0)
            ok += int(nid_ok.sum())
            err += int((pos_err.abs() > 2).sum())
            cfo_abs += float(cfo.abs().sum())
            tot += self.cfg.batch
        return dict(snr_db=snr_db, det_rate=ok / tot,
                    timing_err_rate=err / tot, mean_abs_cfo=cfo_abs / tot)


def main(argv=None):
    p = argparse.ArgumentParser(description="cell-search detection sweep")
    p.add_argument("-B", "--n-rb", type=int, default=25)
    p.add_argument("-s", "--snr0", type=float, default=-12.0)
    p.add_argument("-S", "--snr1", type=float, default=0.0)
    p.add_argument("--step", type=float, default=2.0)
    p.add_argument("-n", "--batches", type=int, default=4)
    p.add_argument("--nid1", type=int, default=0)
    p.add_argument("--nid2", type=int, default=0)
    p.add_argument("--cfo", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back)")
    a = p.parse_args(argv)
    cli_device("syncsim", a.device)
    sim = Syncsim(SyncsimConfig(n_rb=a.n_rb, nid1=a.nid1, nid2=a.nid2,
                                cfo_scs=a.cfo),
                  device=a.device)
    rows = []
    for snr in np.arange(a.snr0, a.snr1 + 1e-9, a.step):
        r = sim.run_snr(float(snr), n_batches=a.batches)
        rows.append(r)
        print(f"SNR {snr:6.1f} dB  det {r['det_rate']:.3f}  "
              f"timing_err {r['timing_err_rate']:.3f}  "
              f"|cfo| {r['mean_abs_cfo']:.4f} scs", flush=True)
    return rows


if __name__ == "__main__":
    main()
