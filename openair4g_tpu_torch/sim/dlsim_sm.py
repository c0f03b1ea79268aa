"""TM3-TM6 downlink link simulator: spatial multiplexing with large-delay
CDD (TM3), closed-loop codebook precoding (TM4), MU-MIMO with a
co-scheduled UE (TM5) and rank-1 closed loop (TM6), two TX ports
(counterpart of openair4g_tpu/sim/dlsim_sm.py `DlsimSm`).

Per trial the channel is a flat Rayleigh H [n_rx, 2], constant over the
subframe and applied to the ports' time-domain signals. The UE estimates
each port's channel from its own pilots, forms the effective channel H·W
and detects: per-RE MMSE for two layers (TM3/4), MRC for one layer
(TM6, and TM5 treating the other UE as noise), or TM5's
interference-aware LLRs. The TM's DCI (2A, 2, 1D or 1B) travels
SFBC-coded in the control region and is blind-decoded every trial; a
missed DCI fails every codeword of its trial.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import FrameParms
from ..device import default_device
from ..ops.equalize_llr import demap_llr_fused
from ..ops.gold import (gold_sequence, pdsch_cinit, scramble_bits,
                        unscramble_llrs)
from ..ops.llr import map_symbols
from ..phy import ofdm
from ..phy.dci_formats import (n_rbg, pack_dci_format1b, pack_dci_format1d,
                               pack_dci_format2, pack_dci_format2a)
from ..phy.mimo_rx import dual_stream_llr, mf_dual_stream, mmse_detect
from ..phy.pdsch import DlschCodec, DlschConfig
from ..phy.precoding import (cdd_precoders_2tx, codebook_2tx,
                             effective_channel, layer_map, precode)
from ..phy.resource_grid import (extract_data_res, fill_grid_port,
                                 make_grid_map)
from .dlsim_mimo import (SfbcPdcch, TrialResult, _idx, estimate_ports,
                         wiener_pair)


@dataclass(frozen=True)
class DlsimSmConfig:
    """The reference's DlsimSmConfig fields and defaults, plus
    decoder_window (None: 96 on the CPU, 240 on a card)."""
    tm: int = 3                  # 3 (CDD SM), 4 (CL SM), 5 (MU-MIMO), 6 (CL r1)
    mcs: int = 4                 # codeword 0
    mcs2: int | None = None      # codeword 1 (TM3/4; defaults to mcs)
    n_rb: int = 25
    n_rx: int = 2
    pmi: int = 1                 # codebook index (TM4 rank 2: 1..2; TM5/6: 0..3)
    pmi_interferer: int = 0      # TM5 co-scheduled UE's PMI
    n_pdcch_symbols: int = 1
    subframe: int = 7
    rnti: int = 0x1234
    n_id_cell: int = 0
    n_turbo_iter: int = 8
    batch: int = 64
    perfect_ce: bool = False
    ia_receiver: bool = True     # TM5: interference-aware LLRs
    decoder_window: int | None = None


class DlsimSm:
    """2-TX spatial-multiplexing link simulator (TM3/4/5/6). `trial` takes
    injected draws; `step` draws them on the simulator's device from a
    torch.Generator; `run_snr` and `sweep` count block errors per
    codeword."""

    def __init__(self, cfg: DlsimSmConfig, device=None):
        if cfg.tm not in (3, 4, 5, 6):
            raise ValueError(f"tm={cfg.tm}: DlsimSm runs TM3, 4, 5 and 6")
        self.cfg = cfg
        self.device = default_device() if device is None \
            else torch.device(device)
        self.rank = 2 if cfg.tm in (3, 4) else 1
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        self.gm = make_grid_map(cfg.n_rb, cfg.n_pdcch_symbols,
                                cfg.n_id_cell, cfg.subframe, nports=2)
        mcs2 = cfg.mcs if cfg.mcs2 is None else cfg.mcs2
        mcss = [cfg.mcs] + ([mcs2] if self.rank == 2 else [])
        self.codecs = [DlschCodec(DlschConfig(
            mcs=m, n_rb=cfg.n_rb, n_pdcch_symbols=cfg.n_pdcch_symbols,
            n_turbo_iter=cfg.n_turbo_iter, nports=2,
            decoder_window=cfg.decoder_window)) for m in mcss]
        for c in self.codecs:
            if self.gm.n_data_re * c.cfg.Qm != c.cfg.G:
                raise ValueError(f"grid holds {self.gm.n_data_re} data REs, "
                                 f"G = {c.cfg.G}")
        self.scr_seqs = [
            gold_sequence(pdsch_cinit(cfg.rnti, q, 2 * cfg.subframe,
                                      cfg.n_id_cell), c.cfg.G)
            for q, c in enumerate(self.codecs)]
        if cfg.tm == 3:
            self.W = cdd_precoders_2tx(self.gm.n_data_re)      # [N, 2, 2]
        elif cfg.tm == 4:
            self.W = codebook_2tx(2)[cfg.pmi]                   # [2, 2]
        else:
            self.W = codebook_2tx(1)[cfg.pmi]                   # [2, 1]
            if cfg.tm == 5:
                self.W_int = codebook_2tx(1)[cfg.pmi_interferer]
        self.pdcch = SfbcPdcch(cfg.n_rb, cfg.n_pdcch_symbols, cfg.n_id_cell,
                               cfg.subframe, cfg.rnti, self._dci_payload())
        self.dci_miss = 0

    def _dci_payload(self) -> np.ndarray:
        """The TM's DCI: 2A (TM3), 2 (TM4), 1D (TM5), 1B (TM6), full band."""
        cfg = self.cfg
        nbg, _ = n_rbg(cfg.n_rb)
        full_band = (1 << nbg) - 1                 # type-0 RBG bitmap
        mcs2 = cfg.mcs if cfg.mcs2 is None else cfg.mcs2
        two_cw = dict(harq_pid=0, tb_swap=0, mcs1=cfg.mcs, ndi1=1, rv1=0,
                      mcs2=mcs2, ndi2=1, rv2=0)
        if cfg.tm == 3:
            return pack_dci_format2a(cfg.n_rb, full_band, **two_cw)
        if cfg.tm == 4:
            return pack_dci_format2(cfg.n_rb, full_band, precoding=cfg.pmi,
                                    **two_cw)
        if cfg.tm == 5:
            return pack_dci_format1d(cfg.n_rb, 0, cfg.n_rb, cfg.mcs,
                                     harq_pid=0, ndi=1, rv=0, tpmi=cfg.pmi,
                                     dl_power_off=0)
        return pack_dci_format1b(cfg.n_rb, 0, cfg.n_rb, cfg.mcs, harq_pid=0,
                                 ndi=1, rv=0, tpmi=cfg.pmi, pmi_confirm=0)

    def wiener(self, snr_db: float):
        """(W0, W1): the ports' complex64 Wiener stacks on the device."""
        return wiener_pair(self.gm, snr_db, self.device)

    def _tx_grids(self, tb_bits, interferer):
        """Encode the codewords, map them to layers, precode onto the two
        port grids [B, nsym, n_fft]."""
        cws = [map_symbols(scramble_bits(c.encode(tb), seq), c.cfg.Qm)
               for c, tb, seq in zip(self.codecs, tb_bits, self.scr_seqs)]
        s = layer_map(cws)                                      # [B, N, L]
        if self.cfg.tm == 5:
            # the co-scheduled UE: QPSK on the interfering PMI, power split
            # equally between the two UEs
            qpsk = torch.tensor([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j],
                                dtype=torch.complex64,
                                device=s.device) / np.sqrt(2)
            s_int = qpsk[interferer.to(s.device)][..., None]     # [B, N, 1]
            tx = (precode(s, self.W) + precode(s_int, self.W_int)) \
                / np.sqrt(2)
        else:
            tx = precode(s, self.W)                             # [B, N, P]
        return fill_grid_port(tx[..., 0], self.gm, 0), \
            fill_grid_port(tx[..., 1], self.gm, 1)

    def trial(self, tb_bits, h_normals, noise_normals, n0, W0, W1,
              interferer=None):
        """[B] subframes on injected draws: tb_bits one [B, TBS_q] {0,1}
        per codeword; h_normals [B, n_rx, 2, 2] and noise_normals
        [B, n_rx, samples_per_tti, 2] standard normals; interferer [B, N]
        QPSK indices 0..3 of the co-scheduled UE (TM5 only); n0 the noise
        variance; W0, W1 from `wiener`. Returns a TrialResult with ok and
        bit_errs [n_cw, B]."""
        cfg, gm, fp = self.cfg, self.gm, self.fp
        dev = self.device
        B, R = tb_bits[0].shape[0], cfg.n_rx
        n0 = float(np.float32(n0))
        tb_bits = [tb.to(dev) for tb in tb_bits]
        if (interferer is None) != (cfg.tm != 5):
            raise ValueError("interferer indices go with TM5 and only TM5")
        g0, g1 = self._tx_grids(tb_bits, interferer)
        if self.pdcch.on:
            self.pdcch.tx(g0, g1)
        t0, t1 = ofdm.ofdm_modulate(g0, fp), ofdm.ofdm_modulate(g1, fp)

        hn = h_normals.to(dev, torch.float32)
        h = torch.complex(hn[..., 0], hn[..., 1]) / np.sqrt(2)  # [B, R, P]
        nn = noise_normals.to(dev, torch.float32)
        sigma = float(np.sqrt(np.float32(n0) / np.float32(2.0)))
        rx = (h[:, :, 0, None] * t0[:, None, :]
              + h[:, :, 1, None] * t1[:, None, :]) \
            + sigma * torch.complex(nn[..., 0], nn[..., 1])    # [B, R, T]
        rgrids = ofdm.ofdm_demodulate(rx.reshape(B * R, -1), fp)
        y = extract_data_res(rgrids, gm).reshape(B, R, -1).transpose(1, 2)

        crm = self.pdcch.crm
        if cfg.perfect_ce:
            H = h[:, :, None, :].expand(B, R, gm.n_data_re, 2)
            H_pd = h[:, :, None, :].expand(B, R, len(crm.pdcch_sym), 2)
        else:
            (h0, hp0), (h1, hp1) = estimate_ports(rgrids, gm, crm, W0, W1)
            H = torch.stack([h0, h1], dim=-1).reshape(B, R, -1, 2)
            H_pd = torch.stack([hp0, hp1], dim=-1).reshape(B, R, -1, 2)
        if self.pdcch.on:
            yp = rgrids[:, _idx(crm.pdcch_sym, dev),
                        _idx(crm.pdcch_bin, dev)].reshape(B, R, -1)
            dci_ok = self.pdcch.rx(yp, H_pd[..., 0], H_pd[..., 1], n0)
        else:
            dci_ok = torch.ones(B, dtype=torch.bool, device=dev)

        if self.rank == 2:
            x_hat, n0_eff = mmse_detect(y, effective_channel(H, self.W), n0)
            llrs = [demap_llr_fused(x_hat[..., q], n0_eff[..., q],
                                    c.cfg.Qm).reshape(B, -1)
                    for q, c in enumerate(self.codecs)]
        else:
            llrs = [self._rank1_llr(y, H, n0)]
        oks, bit_errs = [], []
        llrs = [unscramble_llrs(llr, seq)
                for llr, seq in zip(llrs, self.scr_seqs)]
        for codec, llr, tb in zip(self.codecs, llrs, tb_bits):
            tb_hat, ok, _ = codec.decode(llr)
            oks.append(ok & dci_ok)
            bit_errs.append((tb_hat != tb).sum(dim=1))
        return TrialResult(torch.stack(oks), dci_ok, torch.stack(bit_errs),
                           tuple(llrs))

    def _rank1_llr(self, y, H, n0):
        """One layer (TM5/6) from y [B, N, R] and H [B, R, N, 2] -> [B, G]."""
        cfg = self.cfg
        B = y.shape[0]
        Qm = self.codecs[0].cfg.Qm
        scale = 1.0 / np.sqrt(2) if cfg.tm == 5 else 1.0
        he0 = effective_channel(H, self.W * scale)[..., 0]      # [B, N, R]
        if cfg.tm == 5 and cfg.ia_receiver:
            he1 = effective_channel(H, self.W_int * scale)[..., 0]
            (z0, g0, rho), _ = mf_dual_stream(y, torch.stack([he0, he1], -1))
            return dual_stream_llr(z0, rho, g0, n0, Qm, 2).reshape(B, -1)
        # MRC, any interference counted as noise
        z = (he0.conj() * y).sum(-1)
        g = (he0.abs() ** 2).sum(-1) + 1e-12
        extra = 0.0
        if cfg.tm == 5:
            hei = effective_channel(H, self.W_int * scale)[..., 0]
            extra = (he0.conj() * hei).sum(-1).abs() ** 2 / g
        n0_eff = (n0 * g + extra) / (g * g)
        return demap_llr_fused(z / g, n0_eff, Qm).reshape(B, -1)

    def step(self, generator: torch.Generator, n0, W0, W1) -> TrialResult:
        """[batch] trials drawn on the simulator's device from
        `generator` (a generator of that device)."""
        B, R, dev = self.cfg.batch, self.cfg.n_rx, self.device
        tbs = [torch.randint(0, 2, (B, c.cfg.tbs), generator=generator,
                             device=dev, dtype=torch.int32)
               for c in self.codecs]
        interferer = None
        if self.cfg.tm == 5:
            interferer = torch.randint(0, 4, (B, self.gm.n_data_re),
                                       generator=generator, device=dev)
        h = torch.randn(B, R, 2, 2, generator=generator, device=dev)
        noise = torch.randn(B, R, self.fp.samples_per_tti, 2,
                            generator=generator, device=dev)
        return self.trial(tbs, h, noise, n0, W0, W1, interferer)

    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0):
        """Block errors per codeword at one SNR over ceil(n_frames / batch)
        steps. Returns (errs [n_cw], trials); DCI misses land in
        self.dci_miss."""
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        W0, W1 = self.wiener(snr_db)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        errs = np.zeros(len(self.codecs), np.int64)
        trials = 0
        self.dci_miss = 0
        for _ in range(-(-n_frames // self.cfg.batch)):
            r = self.step(gen, n0, W0, W1)
            errs += (~r.ok).sum(dim=1).cpu().numpy()
            self.dci_miss += int((~r.dci_ok).sum())
            trials += r.ok.shape[1]
        return errs, trials

    def sweep(self, snrs, n_frames: int, seed: int = 0, verbose: bool = True,
              early_exit: bool = True):
        """SNR sweep; rows of (snr, errs [n_cw], trials, bler [n_cw])."""
        rows = []
        for s in snrs:
            errs, trials = self.run_snr(float(s), n_frames, seed)
            bler = errs / max(trials, 1)
            rows.append((float(s), errs.copy(), trials, bler.copy()))
            if verbose:
                txt = " ".join(f"cw{q}:{bler[q]:.4f}({errs[q]}/{trials})"
                               for q in range(len(errs)))
                print(f"SNR {s:+6.2f} dB: {txt}", flush=True)
            if early_exit and errs.sum() == 0:
                break
        return rows
