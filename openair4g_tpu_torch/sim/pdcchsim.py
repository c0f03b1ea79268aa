"""PCFICH + PDCCH (DCI) error-rate Monte-Carlo (counterpart of
openair4g_tpu/sim/pdcchsim.py).

    python3 -m openair4g_tpu_torch.sim.pdcchsim -B 25 -L 4 -s -8 -S 0

The control region (PCFICH and one format-1A DCI at aggregation L) over
AWGN; the UE estimates the channel (Wiener, time-averaged), decodes the
CFI and blind-decodes every aggregation level and CCE offset. The
transmitted waveform is the same in every trial, built once.

`trial` takes the noise normals injected, so it replays another
generator's draws; `step` draws them on the simulator's device.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..convert import wiener_stack_from_reference
from ..device import cli_device, resolve_device
from ..ops.gold import gold_sequence
from ..ops.llr import demap_llr
from ..phy import ofdm
from ..phy.channel_est import estimate_channel, make_wiener_stack
from ..phy.control_region import make_control_region_map
from ..phy.pdcch import (BITS_PER_CCE, cfi_decode, cfi_encode, dci_encode,
                         dci_blind_decode, dci_format1a_size,
                         pack_dci_format1a, pdcch_scramble_seq,
                         search_space_candidates)
from ..phy.resource_grid import fill_grid, make_grid_map
from ..sched.enb_tx import _qpsk, pcfich_cinit
from .dlsim import _idx, _noise


@dataclass(frozen=True)
class PdcchsimConfig:
    n_rb: int = 25
    n_pdcch: int = 3
    n_id_cell: int = 0
    subframe: int = 7
    rnti: int = 0x1234
    L: int = 4                # aggregation level of the test DCI
    cce_offset: int = 0
    batch: int = 64


class Pdcchsim:
    def __init__(self, cfg: PdcchsimConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.fp = fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        self.crm = crm = make_control_region_map(cfg.n_rb, cfg.n_pdcch,
                                                 cfg.n_id_cell)
        self.gm = make_grid_map(cfg.n_rb, cfg.n_pdcch, cfg.n_id_cell,
                                cfg.subframe)
        ns = 2 * cfg.subframe
        pcfich_scr = gold_sequence(pcfich_cinit(cfg.subframe,
                                                 cfg.n_id_cell), 32)
        pcfich_syms = _qpsk(cfi_encode(cfg.n_pdcch)
                            ^ pcfich_scr.astype(np.int8))
        # the DCI: format 1A, encoded at L, scrambled, QPSK; the unused
        # CCEs carry nothing
        self.dci_payload = pack_dci_format1a(
            cfg.n_rb, rb_start=2, n_prb=min(8, cfg.n_rb - 2), mcs=13,
            harq_pid=1, ndi=1, rv=0)
        if len(self.dci_payload) != dci_format1a_size(cfg.n_rb):
            raise ValueError("format 1A payload of the wrong size")
        e = dci_encode(self.dci_payload, cfg.rnti, cfg.L)
        n_cce = crm.n_cce
        scr = pdcch_scramble_seq(cfg.n_id_cell, ns, n_cce * BITS_PER_CCE)
        full = np.zeros(n_cce * BITS_PER_CCE, np.int8)
        s = cfg.cce_offset * BITS_PER_CCE
        full[s:s + len(e)] = e ^ scr[s:s + len(e)]
        used = np.zeros(n_cce * BITS_PER_CCE // 2, bool)
        used[s // 2:(s + len(e)) // 2] = True
        pdcch_syms = np.where(used, _qpsk(full), 0).astype(np.complex64)
        self.candidates = search_space_candidates(n_cce)

        self._c = [_idx(a, dev) for a in (crm.pcfich_sym, crm.pcfich_bin,
                                          crm.pcfich_sc)]
        self._p = [_idx(a, dev) for a in (crm.pdcch_sym, crm.pdcch_bin,
                                          crm.pdcch_sc)]
        grid = fill_grid(torch.zeros(1, self.gm.n_data_re,
                                     dtype=torch.complex64, device=dev),
                         self.gm)
        grid[:, self._c[0], self._c[1]] = torch.as_tensor(pcfich_syms,
                                                          device=dev)
        grid[:, self._p[0], self._p[1]] = torch.as_tensor(pdcch_syms,
                                                          device=dev)
        self.tx = ofdm.ofdm_modulate(grid, fp)          # [1, samples]
        self._cfi_sgn = torch.as_tensor(
            1.0 - 2.0 * pcfich_scr.astype(np.float32), device=dev)
        self._pd_sgn = torch.as_tensor(1.0 - 2.0 * scr.astype(np.float32),
                                       device=dev)
        self._dci_expected = torch.as_tensor(self.dci_payload, device=dev)

    def wiener(self, snr_db: float):
        """The Wiener stack for the pilot symbols' average (noise n0 / 4),
        complex64 on the device."""
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        return wiener_stack_from_reference(
            make_wiener_stack(self.gm, float(n0) / 4.0), self.device)

    def trial(self, noise_normals, n0, W):
        """[B] control regions on injected noise normals [B, samples, 2];
        W from `wiener`. Returns (cfi_ok [B], dci_ok [B]) bool."""
        cfg, dev = self.cfg, self.device
        B = noise_normals.shape[0]
        n0 = float(np.float32(n0))
        r = self.tx + _noise(noise_normals, n0, dev)
        rgrid = ofdm.ofdm_demodulate(r, self.fp)
        H = estimate_channel(rgrid, self.gm, W, time_avg=True)

        def eq_llr(sym, bins, sc):
            y, h = rgrid[:, sym, bins], H[:, sym, sc]
            h2 = h.abs() ** 2
            yeq = y * torch.conj(h) / (h2 + n0)
            return demap_llr(yeq, n0 / (h2 + 1e-9), 2).reshape(B, -1)

        cfi_hat, _ = cfi_decode(eq_llr(*self._c) * self._cfi_sgn)
        found, payload, _ = dci_blind_decode(
            eq_llr(*self._p) * self._pd_sgn, len(self.dci_payload), cfg.rnti,
            self.candidates)
        dci_ok = found & torch.all(payload == self._dci_expected, dim=-1)
        return cfi_hat == cfg.n_pdcch, dci_ok

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
        cfi_ok = dci_ok = tot = 0
        for _ in range(n_batches):
            c, d = self.step(gen, n0, W)
            cfi_ok += int(c.sum())
            dci_ok += int(d.sum())
            tot += self.cfg.batch
        return dict(snr_db=snr_db, cfi_err=1 - cfi_ok / tot,
                    dci_err=1 - dci_ok / tot, trials=tot)


def main(argv=None):
    p = argparse.ArgumentParser(description="PCFICH/PDCCH error-rate sweep")
    p.add_argument("-B", "--n-rb", type=int, default=25)
    p.add_argument("-L", "--agg", type=int, default=4)
    p.add_argument("-s", "--snr0", type=float, default=-8.0)
    p.add_argument("-S", "--snr1", type=float, default=0.0)
    p.add_argument("--step", type=float, default=2.0)
    p.add_argument("-n", "--batches", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back)")
    a = p.parse_args(argv)
    cli_device("pdcchsim", a.device)
    sim = Pdcchsim(PdcchsimConfig(n_rb=a.n_rb, L=a.agg),
                   device=a.device)
    rows = []
    for snr in np.arange(a.snr0, a.snr1 + 1e-9, a.step):
        r = sim.run_snr(float(snr), n_batches=a.batches)
        rows.append(r)
        print(f"SNR {snr:6.1f} dB  CFI err {r['cfi_err']:.4f}  "
              f"DCI err {r['dci_err']:.4f} ({r['trials']} trials)",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
