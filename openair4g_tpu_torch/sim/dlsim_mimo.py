"""TM2 downlink link simulator: two-port transmit diversity (SFBC) with MRC
over the RX antennas (counterpart of openair4g_tpu/sim/dlsim_mimo.py
`DlsimTxDiv`), and the pieces the spatial-multiplexing simulator
(sim/dlsim_sm.py) shares with it: the SFBC-coded PDCCH and the per-port
channel estimation.

One step runs [batch] subframes: DLSCH encode, scrambling, QAM mapping,
SFBC onto the two port grids with each port's own pilots, the UE's
format-1 DCI SFBC-precoded into the control region, the channel applied
per (RX antenna, port) on the grid, one OFDM modulation per RX antenna,
AWGN, per-antenna OFDM demodulation, per-port channel estimation (Wiener
per pilot symbol, averaged over the subframe), SFBC combining, the
max-log demap (the demap_llr kernel), the DCI blind decode and the turbo
decode. SNR is per data RE, as in sim/dlsim.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..config import FrameParms
from ..convert import wiener_stack_from_reference
from ..device import default_device
from ..ops.equalize_llr import demap_llr_fused
from ..ops.gold import (gold_sequence, pdsch_cinit, scramble_bits,
                        unscramble_llrs)
from ..ops.llr import map_symbols
from ..phy import ofdm
from ..phy.alamouti import sfbc_combine, sfbc_encode
from ..phy.channel_est import estimate_channel, make_wiener_stack
from ..phy.control_region import make_control_region_map
from ..phy.dci_formats import n_rbg, pack_dci_format1
from ..phy.pdcch import (BITS_PER_CCE, dci_blind_decode, dci_encode,
                         pdcch_scramble_seq, ue_search_candidates)
from ..phy.pdsch import DlschCodec, DlschConfig
from ..phy.resource_grid import (extract_data_res, fill_grid_port,
                                 make_grid_map)
from .channels import ChannelModel, apply_channel_grid


class TrialResult(NamedTuple):
    ok: torch.Tensor        # [B] (TM2) or [n_cw, B]: TB decoded and DCI found
    dci_ok: torch.Tensor    # [B] DCI blind-decoded with the sent payload
    bit_errs: torch.Tensor  # shaped as ok: decoded TB bits that differ
    llr: tuple              # per codeword, the decoder's input LLRs [B, G]


def _idx(a, dev):
    return torch.as_tensor(a, dtype=torch.long, device=dev)


class SfbcPdcch:
    """The UE's DCI in the control region of a 2-port cell: the coded bits
    of its largest-aggregation UE-specific candidate, QPSK, SFBC-precoded
    onto both port grids (36.211 §6.8.4); at the UE, SFBC combining, the
    max-log demap and the blind decode over the UE's search space. With no
    CCE in the control region (6 PRB at CFI 1) the PDCCH is off."""

    def __init__(self, n_rb: int, n_pdcch_symbols: int, n_id_cell: int,
                 subframe: int, rnti: int, payload: np.ndarray):
        self.crm = make_control_region_map(n_rb, n_pdcch_symbols, n_id_cell)
        self.payload = payload
        self.rnti = rnti
        self.cands = ue_search_candidates(self.crm.n_cce, rnti, subframe)
        self.on = bool(self.cands)
        if not self.on:
            return
        cand = max(self.cands, key=lambda c: c.L)
        e = dci_encode(payload, rnti, cand.L)
        n_bits = self.crm.n_cce * BITS_PER_CCE
        self.scr = pdcch_scramble_seq(n_id_cell, 2 * subframe, n_bits)
        full = np.zeros(n_bits, np.int8)
        off = cand.cce_offset * BITS_PER_CCE
        full[off:off + len(e)] = e ^ self.scr[off:off + len(e)]
        used = np.zeros(n_bits // 2, bool)
        used[off // 2:(off + len(e)) // 2] = True
        syms = ((1 - 2 * full[0::2]) + 1j * (1 - 2 * full[1::2])) \
            / np.sqrt(2)
        self.syms = np.where(used, syms, 0).astype(np.complex64)

    def tx(self, g0, g1) -> None:
        """Write the SFBC-coded PDCCH into both port grids, in place."""
        dev = g0.device
        p0, p1 = sfbc_encode(torch.as_tensor(self.syms, device=dev)[None])
        sym, b = _idx(self.crm.pdcch_sym, dev), _idx(self.crm.pdcch_bin, dev)
        g0[:, sym, b] = p0[0]
        g1[:, sym, b] = p1[0]

    def rx(self, y, h0, h1, n0):
        """y, h0, h1 [B, R, n_pdcch_re] received control REs and the two
        ports' channel there -> dci_ok [B]: the sent payload decoded."""
        B = y.shape[0]
        x_hat, n0_eff = sfbc_combine(y, h0, h1, n0)
        llr = demap_llr_fused(x_hat, n0_eff, 2).reshape(B, -1)
        sgn = torch.as_tensor(1.0 - 2.0 * self.scr.astype(np.float32),
                              device=y.device)
        found, bits, _ = dci_blind_decode(llr * sgn, len(self.payload),
                                          self.rnti, self.cands)
        expected = torch.as_tensor(self.payload, device=y.device)
        return found & torch.all(bits == expected, dim=-1)


def estimate_ports(rgrids, gm, crm, W0, W1):
    """rgrids [B*R, nsym, n_fft] -> per port p, (H_p at the data REs
    [B*R, n_data], H_p at the control REs [B*R, n_pdcch_re]), from port p's
    own pilots (time-averaged Wiener estimates)."""
    dev = rgrids.device
    ds, dc = _idx(gm.data_sym, dev), _idx(gm.data_sc, dev)
    ps, pc = _idx(crm.pdcch_sym, dev), _idx(crm.pdcch_sc, dev)
    out = []
    for port, W in ((0, W0), (1, W1)):
        H = estimate_channel(rgrids, gm, W, time_avg=True, port=port)
        out.append((H[:, ds, dc], H[:, ps, pc]))
    return out


def wiener_pair(gm, snr_db: float, device):
    """The two ports' Wiener stacks for estimate_channel at snr_db, on
    `device` (n0/4 as the reference's simulators set it)."""
    n0 = float(np.float32(10.0 ** (-snr_db / 10.0)))
    return tuple(wiener_stack_from_reference(
        make_wiener_stack(gm, n0 / 4, port=p), device) for p in (0, 1))


@dataclass(frozen=True)
class DlsimTxDivConfig:
    """The reference's DlsimTxDivConfig fields and defaults, plus
    decoder_window (None: 96 on the CPU, 240 on a card)."""
    mcs: int = 4
    n_rb: int = 25
    n_rx: int = 2
    channel: str = "Rayleigh1"
    n_pdcch_symbols: int = 1
    subframe: int = 7
    rnti: int = 0x1234
    n_id_cell: int = 0
    n_turbo_iter: int = 8
    batch: int = 64
    perfect_ce: bool = False
    decoder_window: int | None = None


class DlsimTxDiv:
    """TM2 link simulator. `trial` takes injected draws (TB bits, tap
    normals, noise normals); `step` draws them on the simulator's device
    from a torch.Generator; `run_snr` and `sweep` count block errors."""

    def __init__(self, cfg: DlsimTxDivConfig, device=None):
        self.cfg = cfg
        self.device = default_device() if device is None \
            else torch.device(device)
        self.dlsch = DlschCodec(DlschConfig(
            mcs=cfg.mcs, n_rb=cfg.n_rb, n_pdcch_symbols=cfg.n_pdcch_symbols,
            n_turbo_iter=cfg.n_turbo_iter, nports=2,
            decoder_window=cfg.decoder_window))
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        # SFBC pairs consecutive data REs: the map fills symbols in time
        # order, then subcarriers in frequency order, so pairs are
        # frequency-adjacent within a symbol.
        self.gm = make_grid_map(cfg.n_rb, cfg.n_pdcch_symbols,
                                cfg.n_id_cell, cfg.subframe, nports=2)
        self.chan = ChannelModel(name=cfg.channel, fp=self.fp, n_tx=2,
                                 n_rx=cfg.n_rx)
        G = self.dlsch.cfg.G
        if self.gm.n_data_re * self.dlsch.cfg.Qm != G:
            raise ValueError(f"grid holds {self.gm.n_data_re} data REs, "
                             f"G = {G}")
        self.scr_seq = gold_sequence(
            pdsch_cinit(cfg.rnti, 0, 2 * cfg.subframe, cfg.n_id_cell), G)
        nbg, _ = n_rbg(cfg.n_rb)
        self.pdcch = SfbcPdcch(
            cfg.n_rb, cfg.n_pdcch_symbols, cfg.n_id_cell, cfg.subframe,
            cfg.rnti, pack_dci_format1(cfg.n_rb, (1 << nbg) - 1, cfg.mcs,
                                       harq_pid=0, ndi=1, rv=0))
        self.dci_miss = 0

    def wiener(self, snr_db: float):
        """(W0, W1): the ports' complex64 Wiener stacks on the device."""
        return wiener_pair(self.gm, snr_db, self.device)

    def trial(self, tb_bits, tap_normals, noise_normals, n0, W0, W1):
        """[B] subframes on injected draws: tb_bits [B, TBS] {0,1};
        tap_normals [B, n_rx, 2, T, 2] (with the AoA normals [B] beside
        them for Rice1/Rice8, as ChannelModel.draw_normals gives them) and
        noise_normals [B, n_rx, samples_per_tti, 2] standard normals; n0
        the noise variance; W0, W1 from `wiener`. Returns a
        TrialResult."""
        cfg, codec, gm, fp = self.cfg, self.dlsch, self.gm, self.fp
        dev = self.device
        B, R = tb_bits.shape[0], cfg.n_rx
        n0 = float(np.float32(n0))
        tb_bits = tb_bits.to(dev)
        e = scramble_bits(codec.encode(tb_bits), self.scr_seq)
        p0, p1 = sfbc_encode(map_symbols(e, codec.cfg.Qm))
        g0, g1 = fill_grid_port(p0, gm, 0), fill_grid_port(p1, gm, 1)
        if self.pdcch.on:
            self.pdcch.tx(g0, g1)

        # channel [B, R, port, taps], constant over the subframe, applied
        # per (RX antenna, port) on the grid; one OFDM modulation per RX
        taps = self.chan.draw_taps(B, normals=tap_normals, device=dev)
        Hf = self.chan.freq_response(taps)               # [B, R, 2, n_sc]
        faded = sum(apply_channel_grid(g.repeat_interleave(R, dim=0),
                                       Hf[:, :, p].reshape(B * R, -1), fp)
                    for p, g in ((0, g0), (1, g1)))
        t = ofdm.ofdm_modulate(faded, fp).reshape(B, R, -1)
        nn = noise_normals.to(dev, torch.float32)
        sigma = float(np.sqrt(np.float32(n0) / np.float32(2.0)))
        rx = t + sigma * torch.complex(nn[..., 0], nn[..., 1])
        rgrids = ofdm.ofdm_demodulate(rx.reshape(B * R, -1), fp)

        crm = self.pdcch.crm
        if cfg.perfect_ce:
            dc, pc = _idx(gm.data_sc, dev), _idx(crm.pdcch_sc, dev)
            (h0, hp0), (h1, hp1) = [(Hf[:, :, p][:, :, dc],
                                     Hf[:, :, p][:, :, pc]) for p in (0, 1)]
        else:
            (h0, hp0), (h1, hp1) = [
                (hd.reshape(B, R, -1), hc.reshape(B, R, -1))
                for hd, hc in estimate_ports(rgrids, gm, crm, W0, W1)]
        if self.pdcch.on:
            yp = rgrids[:, _idx(crm.pdcch_sym, dev),
                        _idx(crm.pdcch_bin, dev)].reshape(B, R, -1)
            dci_ok = self.pdcch.rx(yp, hp0, hp1, n0)
        else:
            dci_ok = torch.ones(B, dtype=torch.bool, device=dev)

        y = extract_data_res(rgrids, gm).reshape(B, R, -1)
        x_hat, n0_eff = sfbc_combine(y, h0, h1, n0)
        llr = demap_llr_fused(x_hat, n0_eff, codec.cfg.Qm).reshape(B, -1)
        llr = unscramble_llrs(llr, self.scr_seq)
        tb_hat, tb_ok, _ = codec.decode(llr)
        bit_errs = (tb_hat != tb_bits).sum(dim=1)
        return TrialResult(tb_ok & dci_ok, dci_ok, bit_errs, (llr,))

    def step(self, generator: torch.Generator, n0, W0, W1) -> TrialResult:
        """[batch] trials drawn on the simulator's device from
        `generator` (a generator of that device)."""
        B, dev = self.cfg.batch, self.device
        tb = torch.randint(0, 2, (B, self.dlsch.cfg.tbs), generator=generator,
                           device=dev, dtype=torch.int32)
        taps = self.chan.draw_normals(B, generator, dev)
        noise = torch.randn(B, self.cfg.n_rx, self.fp.samples_per_tti, 2,
                            generator=generator, device=dev)
        return self.trial(tb, taps, noise, n0, W0, W1)

    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0):
        """Block errors at one SNR over ceil(n_frames / batch) steps.
        Returns (errs, trials); DCI misses land in self.dci_miss."""
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        W0, W1 = self.wiener(snr_db)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        errs = trials = 0
        self.dci_miss = 0
        for _ in range(-(-n_frames // self.cfg.batch)):
            r = self.step(gen, n0, W0, W1)
            errs += int((~r.ok).sum())
            self.dci_miss += int((~r.dci_ok).sum())
            trials += r.ok.numel()
        return errs, trials

    def sweep(self, snrs, n_frames: int, seed: int = 0, verbose: bool = True,
              early_exit: bool = True):
        """SNR sweep; rows of (snr, [errs], [trials], [bler])."""
        rows = []
        for s in snrs:
            errs, trials = self.run_snr(float(s), n_frames, seed)
            bler = errs / max(trials, 1)
            rows.append((float(s), np.array([errs]), np.array([trials]),
                         np.array([bler])))
            if verbose:
                print(f"SNR {s:+6.2f} dB: bler {bler:.4f} ({errs}/{trials})",
                      flush=True)
            if early_exit and errs == 0:
                break
        return rows
