"""PUSCH link-level simulator with HARQ (counterpart of
openair4g_tpu/sim/ulsim.py).

One `Ulsim` trial runs [batch] subframes through every HARQ round: UL-SCH
encode (the DL-SCH bit chain, phy/pdsch.DlschCodec), then per round
rv = round & 3 rate matching, scrambling, QAM mapping, CQI/RI/ACK
multiplexing (ops/uci.py) or the data-only channel interleaver, transform
precoding and the DMRS, the round's channel (a per-subcarrier multiply, per
slot under frequency hopping, or the time-domain FIR), AWGN, OFDM
demodulation, DMRS channel estimation (or the genie channel), SC-FDMA MMSE
equalization and despreading, the plain max-log demap, control
demultiplexing and the turbo decode of the soft-combined buffers. The
round-0 UCI detection errors are counted beside the data's. SNR is per
RE: n0 = 10^(-SNR/10) with unit-energy symbols and unitary transforms.

`trial` takes every draw injected (TB bits, UCI bits; per round the
channel normals and the noise normals), so it replays another
generator's draws; `step` draws them on the simulator's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..config import FrameParms
from ..device import resolve_device
from ..ops.gold import gold_sequence, pusch_cinit
from ..ops.llr import demap_llr, map_symbols
from ..ops.segmentation import segment_tb
from ..ops.uci import (UciConfig, cqi_decode, cqi_encode_device,
                       make_uci_maps, uci1_decode, uci1_symbols, uci2_decode,
                       uci2_symbols, uci_demultiplex, uci_multiplex)
from ..phy import ofdm
from ..phy.hopping import pusch_hopped_rb_start
from ..phy.pdsch import DlschCodec
from ..phy.pusch import (UlschConfig, make_ul_wiener, scfdma_mmse_equalize,
                         ul_estimate_channel)
from ..phy.scfdma import (make_pusch_map, pusch_extract, pusch_fill_grid_x,
                          transform_deprecode)
from ..phy.ulref import pusch_dmrs
from ..tables.tbs import get_Qm_ul, get_TBS_UL
from .channels import ChannelModel, apply_channel_bins, apply_channel_time
from .dlsim import _noise


@dataclass(frozen=True)
class UlsimConfig:
    """The reference's UlsimConfig fields and defaults, plus decoder_window
    (None: 96 on the CPU, 240 on a card)."""
    mcs: int = 10
    n_rb: int = 25                # system bandwidth
    n_rb_alloc: int = 25          # PUSCH allocation width
    rb_offset: int = 0
    channel: str = "AWGN"
    n_harq_rounds: int = 1
    perfect_ce: bool = False
    subframe: int = 0
    rnti: int = 0x1234
    n_id_cell: int = 0
    n_turbo_iter: int = 8
    batch: int = 64
    dmrs_group: int = 0           # u (group hopping off)
    dmrs_cyclic_shift: int = 0
    uci: UciConfig = field(default_factory=UciConfig)
    # PUSCH frequency hopping (36.211 §5.3.4): the DCI-0 hopping bits, or
    # None for none; the all-ones value selects type 2 (sub-band hopping
    # over n_sb sub-bands, n_rb_ho PRBs outside the region), others type 1.
    hopping_bits: int | None = None
    n_sb: int = 1
    n_rb_ho: int = 0
    time_domain_channel: bool = False   # the FIR on the sample stream
    decoder_window: int | None = None


class UlTrialResult(NamedTuple):
    ok: torch.Tensor        # [R, B] TB decoded in round r
    errs: torch.Tensor      # [R] trials that reached round r and failed it
    reach: torch.Tensor     # [R] trials that reached round r
    uci_errs: torch.Tensor  # [3] round-0 CQI, RI and ACK detection errors


class Ulsim:
    """Uplink link simulator with HARQ; a fresh channel every round (the
    reference ulsim's default), rv cycling 0, 1, 2, 3, soft combining in
    the per-block buffers."""

    def __init__(self, cfg: UlsimConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        rb2 = None
        if cfg.hopping_bits is not None:
            rb2 = pusch_hopped_rb_start(
                cfg.rb_offset, cfg.n_rb_alloc, cfg.n_rb, 1,
                cfg.hopping_bits, cfg.n_id_cell, cfg.n_sb, cfg.n_rb_ho)
        self.pm = pm = make_pusch_map(cfg.n_rb, cfg.n_rb_alloc,
                                      cfg.rb_offset, rb_offset2=rb2)
        if cfg.time_domain_channel and (pm.hopped or cfg.perfect_ce):
            raise ValueError("time_domain_channel runs estimated CE on an "
                             "unhopped allocation")
        Qm = get_Qm_ul(cfg.mcs)
        C = len(pm.data_syms)
        self.uci_maps = None
        g_override = None
        if cfg.uci.any:
            u = cfg.uci
            sum_kr = sum(segment_tb(get_TBS_UL(cfg.mcs, cfg.n_rb_alloc)
                                    + 24).block_sizes)
            self.uci_maps = make_uci_maps(
                pm.m_sc, C, Qm, sum_kr, u.o_cqi, u.o_ri, u.o_ack,
                u.beta_cqi, u.beta_ri, u.beta_ack, self.fp.normal_cp)
            g_override = self.uci_maps.G_data
        self.ulsch = UlschConfig(mcs=cfg.mcs, n_rb_alloc=cfg.n_rb_alloc,
                                 n_turbo_iter=cfg.n_turbo_iter,
                                 decoder_window=cfg.decoder_window,
                                 g_override=g_override)
        self.codec = DlschCodec(self.ulsch)   # the DL-SCH bit chain
        self.dmrs = pusch_dmrs(pm.m_sc, u=cfg.dmrs_group,
                               cyclic_shift=cfg.dmrs_cyclic_shift)
        self.chan = ChannelModel(name=cfg.channel, fp=self.fp)
        self.f_idx = tuple((cfg.rb_offset * 12 + np.arange(pm.m_sc)
                            - 6 * cfg.n_rb).tolist())
        self.f_idx2 = tuple((pm.rb_offset2 * 12 + np.arange(pm.m_sc)
                             - 6 * cfg.n_rb).tolist())
        self.bins2 = np.mod(np.asarray(self.f_idx2), self.fp.n_fft).astype(
            np.int32)
        # the scrambling sequence over the interleaved grid (row-major
        # [C, M, Qm], the 36.211 §5.3.1 order); UCI positions take the x/y
        # placeholder rules and bypass it
        cinit = pusch_cinit(cfg.rnti, 2 * cfg.subframe, cfg.n_id_cell)
        full = gold_sequence(cinit, C * pm.m_sc * Qm).reshape(C * pm.m_sc, Qm)
        m = self.uci_maps
        scr_cqi = None
        if m is None:
            scr = full.reshape(-1)[:self.ulsch.G]
        else:
            scr = full[m.data_pos].reshape(-1)
            if m.qp_cqi:
                scr_cqi = full[m.cqi_pos].reshape(-1)
        self._scr = torch.as_tensor(scr, dtype=torch.int32, device=dev)
        self._scr_sgn = 1.0 - 2.0 * self._scr.to(torch.float32)
        if scr_cqi is not None:
            self._scr_cqi = torch.as_tensor(scr_cqi, dtype=torch.int32,
                                            device=dev)
            self._scr_cqi_sgn = 1.0 - 2.0 * self._scr_cqi.to(torch.float32)
        self._ileave = torch.as_tensor(pm.interleave, dtype=torch.long,
                                       device=dev)
        self._deileave = torch.as_tensor(pm.deinterleave, dtype=torch.long,
                                         device=dev)
        self.uci_errs = np.zeros(3, np.int64)

    def wiener(self, snr_db: float) -> torch.Tensor:
        """The estimator's [M, M] complex64 smoothing matrix on the device."""
        return make_ul_wiener(self.pm, 10.0 ** (-snr_db / 10.0), self.device)

    # ------------------------------------------------------------------ TX --
    def _tx_symbols(self, e_scrambled, uci_bits):
        """Data (and UCI) onto the [B, C, M] pre-DFT symbol grid."""
        Qm = self.ulsch.Qm
        data_sym = map_symbols(e_scrambled, Qm)
        m = self.uci_maps
        if m is None:
            B = data_sym.shape[0]
            return data_sym[:, self._ileave].reshape(
                B, len(self.pm.data_syms), self.pm.m_sc)
        cqi_sym = ri_sym = ack_sym = None
        if m.qp_cqi:
            q = cqi_encode_device(uci_bits["cqi"], m.Q_cqi)
            cqi_sym = map_symbols(torch.bitwise_xor(q, self._scr_cqi), Qm)
        if m.qp_ri:
            ri_sym = uci1_symbols(uci_bits["ri"][:, 0], Qm, m.qp_ri)
        if m.qp_ack:
            if self.cfg.uci.o_ack == 1:
                ack_sym = uci1_symbols(uci_bits["ack"][:, 0], Qm, m.qp_ack)
            else:
                ack_sym = uci2_symbols(uci_bits["ack"], Qm, m.qp_ack)
        return uci_multiplex(data_sym, cqi_sym, ri_sym, ack_sym, m)

    # ------------------------------------------------------------------ RX --
    def _rx_llrs(self, x_time, n0_eff):
        """Despread symbols [B, C, M] -> (data LLRs [B, G], UCI streams)."""
        llr = demap_llr(x_time, n0_eff, self.ulsch.Qm)     # [B, C, M, Qm]
        if self.uci_maps is None:
            B = llr.shape[0]
            data = llr.reshape(B, -1, self.ulsch.Qm)[:, self._deileave]
            return data.reshape(B, -1) * self._scr_sgn, {}
        streams = uci_demultiplex(llr, self.uci_maps)
        return streams["data"] * self._scr_sgn, streams

    def _uci_errors(self, streams, uci_bits):
        """Round-0 UCI detection error counts [cqi, ri, ack]."""
        m = self.uci_maps
        out = torch.zeros(3, dtype=torch.int64, device=self.device)
        if m is None:
            return out
        if m.qp_cqi:
            cqi_llr = streams["cqi"] * self._scr_cqi_sgn
            bits, ok = cqi_decode(cqi_llr, self.cfg.uci.o_cqi)
            err = torch.any(bits != uci_bits["cqi"], dim=-1) | ~ok
            out[0] = err.sum()
        if m.qp_ri:
            ri_hat = uci1_decode(streams["ri"])
            out[1] = (ri_hat != uci_bits["ri"][:, 0]).sum()
        if m.qp_ack:
            if self.cfg.uci.o_ack == 1:
                ack_hat = uci1_decode(streams["ack"])[:, None]
            else:
                ack_hat = uci2_decode(streams["ack"])
            out[2] = torch.any(ack_hat != uci_bits["ack"], dim=-1).sum()
        return out

    def _channel(self, grid, taps, noise):
        """The round's channel and AWGN. Returns (received grid, the genie
        channel [B, M] of each slot)."""
        cfg, fp, pm, chan = self.cfg, self.fp, self.pm, self.chan
        H = chan.freq_response_at(taps, self.f_idx)             # [B, M]
        half = fp.symbols_per_subframe // 2
        H2 = H
        if cfg.time_domain_channel:
            t = apply_channel_time(ofdm.ofdm_modulate(grid, fp), chan, taps)
        elif pm.hopped:
            # per slot: slot 1 sits at the hopped PRBs and sees the
            # channel there
            H2 = chan.freq_response_at(taps, self.f_idx2)
            g0 = apply_channel_bins(grid[:, :half], H, pm.sc_bins, fp.n_fft)
            g1 = apply_channel_bins(grid[:, half:], H2, self.bins2, fp.n_fft)
            t = ofdm.ofdm_modulate(torch.cat([g0, g1], dim=1), fp)
        else:
            t = ofdm.ofdm_modulate(
                apply_channel_bins(grid, H, pm.sc_bins, fp.n_fft), fp)
        return ofdm.ofdm_demodulate(t + noise, fp), H, H2

    def _genie(self, H, H2, shape):
        """The genie channel on the data symbols [B, C, M]."""
        if not self.pm.hopped:
            return H[:, None].expand(shape)
        half = self.fp.symbols_per_subframe // 2
        return torch.stack([H if l < half else H2
                            for l in self.pm.data_syms], dim=1)

    def round_llrs(self, rnd: int, d_flats, uci_bits, tap_draw, noise_draw,
                   n0: float, W):
        """HARQ round `rnd` up to the decoder: d_flats the encoder's streams
        (DlschCodec.encode_to_d), uci_bits as `trial` takes them, this
        round's channel and noise normals. Returns (the unscrambled data
        LLRs [B, G], the UCI streams)."""
        B, dev = d_flats[0].shape[0], self.device
        e = torch.bitwise_xor(self.codec.select_e(d_flats, rnd & 3),
                              self._scr)
        grid = pusch_fill_grid_x(self._tx_symbols(e, uci_bits), self.pm,
                                 self.dmrs)
        taps = self.chan.draw_taps(B, normals=tap_draw, device=dev)
        rgrid, H, H2 = self._channel(grid, taps, _noise(noise_draw, n0, dev))
        y, dmrs_rx = pusch_extract(rgrid, self.pm)
        if self.cfg.perfect_ce:
            H_data = self._genie(H, H2, y.shape)
        else:
            H_data = ul_estimate_channel(dmrs_rx, self.dmrs, self.pm, W)
        xf, n0_eff = scfdma_mmse_equalize(y, H_data, n0)
        return self._rx_llrs(transform_deprecode(xf), n0_eff)

    def trial(self, tb_bits, uci_bits, tap_normals, noise_normals, n0,
              W) -> UlTrialResult:
        """[B] trials through every HARQ round on injected draws.

        tb_bits [B, TBS] {0,1}; uci_bits a dict of the configured fields,
        "cqi" [B, o_cqi], "ri" [B, 1], "ack" [B, o_ack] (empty without
        UCI); per round r, tap_normals[r] what ChannelModel.draw_normals
        gives ([B, 1, 1, T, 2], None for AWGN) and noise_normals[r]
        [B, samples_per_tti, 2]; n0 the noise variance; W from `wiener`."""
        dev = self.device
        B = tb_bits.shape[0]
        n0 = float(np.float32(n0))
        tb_bits = tb_bits.to(dev)
        uci_bits = {k: v.to(dev) for k, v in (uci_bits or {}).items()}
        d_flats = self.codec.encode_to_d(tb_bits)
        oks, w_soft = [], None
        uci_errs = None
        for rnd in range(self.cfg.n_harq_rounds):
            llr, streams = self.round_llrs(rnd, d_flats, uci_bits,
                                           tap_normals[rnd],
                                           noise_normals[rnd], n0, W)
            if rnd == 0:
                uci_errs = self._uci_errors(streams, uci_bits)
            _, ok, w_soft = self.codec.decode(llr, w_soft=w_soft, rv=rnd & 3)
            oks.append(ok)
        ok = torch.stack(oks)
        # a trial reaches round r while no earlier round decoded it
        ok_any = torch.cummax(ok.to(torch.int32), dim=0).values.bool()
        fail = (~ok_any).sum(dim=1)
        reach = torch.cat([fail.new_full((1,), B), fail[:-1]])
        return UlTrialResult(ok, fail, reach, uci_errs)

    def draw(self, generator: torch.Generator):
        """One trial's draws for `trial`, on the simulator's device."""
        cfg, dev, B = self.cfg, self.device, self.cfg.batch
        tb = torch.randint(0, 2, (B, self.ulsch.tbs), generator=generator,
                           device=dev, dtype=torch.int32)
        u = cfg.uci
        uci = {name: torch.randint(0, 2, (B, n), generator=generator,
                                   device=dev, dtype=torch.int32)
               for name, n in (("cqi", u.o_cqi), ("ri", u.o_ri),
                               ("ack", u.o_ack)) if n}
        taps, noise = [], []
        for _ in range(cfg.n_harq_rounds):
            taps.append(self.chan.draw_normals(B, generator, dev))
            noise.append(torch.randn(B, self.fp.samples_per_tti, 2,
                                     generator=generator, device=dev))
        return tb, uci, taps, noise

    def step(self, generator: torch.Generator, n0, W) -> UlTrialResult:
        """[batch] trials through every round, drawn on the simulator's
        device from `generator` (a generator of that device)."""
        return self.trial(*self.draw(generator), n0, W)

    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0):
        """Per-round (errs [R], trials [R]) over ceil(n_frames / batch)
        steps; the round-0 UCI error counts of the same trials land in
        self.uci_errs = [cqi, ri, ack]."""
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        W = self.wiener(snr_db)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        R = self.cfg.n_harq_rounds
        errs = np.zeros(R, np.int64)
        reach = np.zeros(R, np.int64)
        uci = np.zeros(3, np.int64)
        for _ in range(-(-n_frames // self.cfg.batch)):
            res = self.step(gen, n0, W)
            errs += res.errs.cpu().numpy()
            reach += res.reach.cpu().numpy()
            uci += res.uci_errs.cpu().numpy()
        self.uci_errs = uci
        return errs, reach

    def sweep(self, snrs, n_frames: int, seed: int = 0, verbose: bool = True,
              early_exit: bool = True):
        """SNR sweep; rows of (snr, errs [R], trials [R], bler [R],
        uci_errs [3])."""
        rows = []
        for s in snrs:
            errs, reach = self.run_snr(float(s), n_frames, seed)
            uci = self.uci_errs
            bler = errs / np.maximum(reach, 1)
            rows.append((float(s), errs.copy(), reach.copy(), bler.copy(),
                         uci.copy()))
            if verbose:
                txt = " ".join(f"r{r}:{bler[r]:.3f}({errs[r]}/{reach[r]})"
                               for r in range(len(bler)))
                if self.cfg.uci.any:
                    txt += (f"  uci[cqi:{uci[0]} ri:{uci[1]} ack:{uci[2]}"
                            f"/{reach[0]}]")
                print(f"SNR {s:+6.2f} dB: {txt}", flush=True)
            if early_exit and errs[-1] == 0:
                break
        return rows
