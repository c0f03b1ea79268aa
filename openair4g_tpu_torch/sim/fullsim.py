"""Full eNB-TX -> UE-RX chain simulator (counterpart of
openair4g_tpu/sim/fullsim.py; BASELINE config 4: "20 MHz full chain w/
HARQ").

Reference parity: the combination dlsim exercises per trial once synced.
eNB TX builds the complete subframe (pilots, PCFICH, PHICH, PDCCH DCI
format 1A, PDSCH; phy_procedures_eNB_TX, phy_procedures_lte_eNb.c:1372);
the UE runs the complete receiver (blind DCI search, channel estimation,
PDSCH demod + turbo decode, PHICH; phy_procedures_UE_RX,
phy_procedures_lte_ue.c:2398); a missed DCI voids the TB exactly like
dlsim's errs[0] accounting (dlsim.c:3011-3023). Cold start (PSS/SSS/PBCH
from a timing-offset capture) mirrors initial_sync.c:274.

One trial runs [batch] subframes through every HARQ round: encode once,
then per round rv = round & 3 rate matching, the round's channel and
AWGN, and the UE's round with the per-block soft buffers carried across
rounds. `trial` takes every draw injected (TB bits, the PHICH ACK bit;
per round the channel normals and the noise normals), so it replays
another generator's draws; `step` draws them on the simulator's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..convert import wiener_stack_from_reference
from ..device import resolve_device
from ..ops.gold import scramble_bits
from ..ops.llr import demap_llr, map_symbols
from ..phy import ofdm
from ..phy.channel_est import estimate_channel, make_wiener_stack
from ..phy.pbch import make_pbch_map, pbch_blind_decode, unpack_mib
from ..phy.pdcch import dci_blind_decode
from ..phy.resource_grid import make_grid_map
from ..phy.sync import CellSearch
from ..sched.enb_tx import CellConfig, EnbTx, _long
from ..sched.ue_rx import UeRx
from .channels import ChannelModel, apply_channel_bins
from .dlsim import _noise


@dataclass(frozen=True)
class FullsimConfig:
    """The reference's FullsimConfig fields and defaults, plus
    decoder_window (None: 96 on the CPU, 240 on a card)."""
    n_rb: int = 100               # 20 MHz
    mcs: int = 4
    rb_start: int = 0
    n_prb: int | None = None      # default: full band
    channel: str = "AWGN"
    n_harq_rounds: int = 4
    n_pdcch: int = 3
    n_id_cell: int = 0
    rnti: int = 0x1234
    subframe: int = 7
    n_turbo_iter: int = 8
    batch: int = 32
    decoder_window: int | None = None


class FullRound(NamedTuple):
    ok: torch.Tensor          # [B] DCI found with the sent payload and TB
    dci_found: torch.Tensor   # [B] DCI found with the sent payload
    tb_ok: torch.Tensor       # [B] TB CRC passed
    phich_ack: torch.Tensor   # [B] PHICH decision (True = ACK)
    w_soft: list              # per-block soft buffers [B, L]


class FullTrialResult(NamedTuple):
    rounds: list              # one FullRound per HARQ round
    errs: torch.Tensor        # [R] trials that reached round r and failed it
    reach: torch.Tensor       # [R] trials that reached round r
    dci_miss: torch.Tensor    # round-0 DCI misses
    phich_err: torch.Tensor   # round-0 PHICH decisions against the sent ACK


class FullChainSim:
    """The full chain on `device` (None: the card)."""

    def __init__(self, cfg: FullsimConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        n_prb = cfg.n_rb if cfg.n_prb is None else cfg.n_prb
        self.cell = CellConfig(
            n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell, n_pdcch=cfg.n_pdcch,
            rnti=cfg.rnti, rb_start=cfg.rb_start, n_prb=n_prb, mcs=cfg.mcs,
            subframe=cfg.subframe)
        self.enb = EnbTx(self.cell, dev)
        self.ue = UeRx(self.cell, n_turbo_iter=cfg.n_turbo_iter, device=dev,
                       decoder_window=cfg.decoder_window)
        self.fp = self.enb.fp
        self.chan = ChannelModel(name=cfg.channel, fp=self.fp)
        self.codec = self.ue.codec
        self.scr_seq = self.ue.scr_seq
        self._f_idx = tuple((np.arange(self.fp.n_sc)
                             - 6 * self.fp.n_rb).tolist())
        self._bins = self.fp.sc_to_bin(np.arange(self.fp.n_sc))
        self._expected = torch.as_tensor(self.enb.dci_payload, device=dev)
        self.dci_miss = 0
        self.phich_err = 0

    # ----------------------------------------------------------- cold start --
    def cold_start(self, snr_db: float, batch: int = 16, seed: int = 0):
        """PSS/SSS sync + PBCH MIB decode from a noisy capture with random
        timing offset, drawn on the host from numpy's default_rng(seed).
        Returns dict with detection rates (initial_sync) and the first
        trial's MIB."""
        fp, dev = self.fp, self.device
        grid0 = self.enb.sync_subframe_host(sfn=0)
        wave = ofdm.ofdm_modulate_host(grid0[None], fp)[0]
        search = CellSearch(fp)
        L = search.capture_len
        max_off = L - fp.samples_per_tti - fp.n_fft
        n0 = 10.0 ** (-snr_db / 10.0)
        rng = np.random.default_rng(seed)
        offs = rng.integers(0, max_off, batch)
        caps = np.zeros((batch, L), np.complex64)
        for b in range(batch):
            caps[b, offs[b]:offs[b] + len(wave)] = wave
        caps += (rng.standard_normal((batch, L))
                 + 1j * rng.standard_normal((batch, L))).astype(np.complex64) \
            * np.sqrt(n0 / 2)
        res = search.search(torch.as_tensor(caps, device=dev))
        pss_t0 = (fp.cp0 + fp.n_fft) + 5 * (fp.cp + fp.n_fft) + fp.cp
        nid_ok = ((res["nid2"] == self.cell.n_id_cell % 3)
                  & (res["nid1"] == self.cell.n_id_cell // 3)).cpu().numpy()
        pos_ok = np.abs(res["pss_pos"].cpu().numpy()
                        - (offs + pss_t0)) <= 2

        # PBCH from the frame-aligned grid (perfectly re-centered captures
        # for the MIB stage; timing recovery is scored above)
        aligned = np.stack([caps[b, offs[b]:offs[b] + fp.samples_per_tti]
                            for b in range(batch)])
        rgrid = ofdm.ofdm_demodulate(torch.as_tensor(aligned, device=dev), fp)
        gm0 = make_grid_map(self.cell.n_rb, 1, self.cell.n_id_cell,
                            subframe=0)   # subframe-0 pilot values
        W = wiener_stack_from_reference(make_wiener_stack(gm0, n0 / 4.0), dev)
        H = estimate_channel(rgrid, gm0, W, time_avg=True)
        pm = make_pbch_map(self.cell.n_rb, self.cell.n_id_cell)
        sym = _long(pm.sym, dev)
        y = rgrid[:, sym, _long(pm.bins, dev)]
        h = H[:, sym, _long(pm.sc, dev)]
        # the plain demap with g clamped at 1e-9, as the reference's
        g = torch.clamp(h.abs() ** 2, min=1e-9)
        llr = demap_llr(y * torch.conj(h) / g, n0 / g, 2).reshape(batch, -1)
        mib_ok, mib_bits, _, _ = pbch_blind_decode(llr, self.cell.n_id_cell)
        mib = unpack_mib(mib_bits[0].cpu().numpy())
        return dict(sync_rate=float(nid_ok.mean()),
                    timing_rate=float(pos_ok.mean()),
                    mib_rate=float(mib_ok.cpu().numpy().mean()),
                    mib=mib)

    # ------------------------------------------------------------ data step --
    def _ue_round(self, rgrid, n0: float, wiener, w_soft, rv: int):
        """UeRx.receive, HARQ-aware (the soft buffers carried, rv): no CFI
        decode; the DCI counts as found only with the sent payload."""
        ue = self.ue
        H = ue.channel(rgrid, wiener)
        found, payload, _ = dci_blind_decode(
            ue.pdcch_llrs(rgrid, H, n0), ue.dci_len, self.cell.rnti,
            ue.candidates)
        dci_found = found & torch.all(payload == self._expected, dim=-1)
        _, phich_ack = ue.phich(rgrid, H, n0)
        _, tb_ok, w_new = self.codec.decode(ue.pdsch_llrs(rgrid, H, n0),
                                            w_soft=w_soft, rv=rv)
        return dci_found, tb_ok, phich_ack, w_new

    def trial(self, tb_bits, ack_bits, tap_normals, noise_normals, n0,
              wiener) -> FullTrialResult:
        """[B] trials through every HARQ round on injected draws.

        tb_bits [B, TBS] {0,1}; ack_bits [B] {0,1}, the PHICH's ACK bit;
        per round r, tap_normals[r] what ChannelModel.draw_normals gives
        ([B, 1, 1, T, 2], None for AWGN) and noise_normals[r] [B,
        samples_per_tti, 2]; n0 the noise variance; wiener from
        self.ue.make_wiener(n0)."""
        cfg, codec, dev = self.cfg, self.codec, self.device
        B = tb_bits.shape[0]
        n0 = float(np.float32(n0))
        tb_bits = tb_bits.to(dev)
        ack_bits = ack_bits.to(dev)
        d_flats = codec.encode_to_d(tb_bits)
        rounds, w_soft = [], None
        for rnd in range(cfg.n_harq_rounds):
            rv = rnd & 3
            e = scramble_bits(codec.select_e(d_flats, rv), self.scr_seq)
            grid = self.enb.data_subframe(map_symbols(e, codec.cfg.Qm),
                                          ack_bits=ack_bits)
            taps = self.chan.draw_taps(B, normals=tap_normals[rnd],
                                       device=dev)
            H = self.chan.freq_response_at(taps, self._f_idx)   # [B, n_sc]
            grid = apply_channel_bins(grid, H, self._bins, self.fp.n_fft)
            t = ofdm.ofdm_modulate(grid, self.fp)
            rgrid = ofdm.ofdm_demodulate(
                t + _noise(noise_normals[rnd], n0, dev), self.fp)
            dci_found, tb_ok, phich_ack, w_soft = self._ue_round(
                rgrid, n0, wiener, w_soft, rv)
            rounds.append(FullRound(dci_found & tb_ok, dci_found, tb_ok,
                                    phich_ack, w_soft))
        # a trial reaches round r while no earlier round decoded it
        ok_any = torch.cummax(torch.stack([r.ok for r in rounds]).to(
            torch.int32), dim=0).values.bool()
        fail = (~ok_any).sum(dim=1)
        reach = torch.cat([fail.new_full((1,), B), fail[:-1]])
        r0 = rounds[0]
        return FullTrialResult(rounds, fail, reach, (~r0.dci_found).sum(),
                               (r0.phich_ack != ack_bits.bool()).sum())

    def draw(self, generator: torch.Generator):
        """One step's draws for `trial`, on the simulator's device."""
        cfg, dev, B = self.cfg, self.device, self.cfg.batch
        tb = torch.randint(0, 2, (B, self.codec.cfg.tbs), generator=generator,
                           device=dev, dtype=torch.int32)
        ack = torch.randint(0, 2, (B,), generator=generator, device=dev,
                            dtype=torch.int32)
        taps, noise = [], []
        for _ in range(cfg.n_harq_rounds):
            taps.append(self.chan.draw_normals(B, generator, dev))
            noise.append(torch.randn(B, self.fp.samples_per_tti, 2,
                                     generator=generator, device=dev))
        return tb, ack, taps, noise

    def step(self, generator: torch.Generator, n0, wiener) -> FullTrialResult:
        """[batch] trials through every round, drawn on the simulator's
        device from `generator` (a generator of that device)."""
        return self.trial(*self.draw(generator), n0, wiener)

    # ---------------------------------------------------------- SNR sweep --
    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0):
        """Per-round (errs [R], trials [R]) over ceil(n_frames / batch)
        steps; round-0 DCI misses and PHICH errors land in self.dci_miss
        and self.phich_err."""
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        W = self.ue.make_wiener(float(n0))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        R = self.cfg.n_harq_rounds
        errs = np.zeros(R, np.int64)
        reach = np.zeros(R, np.int64)
        self.dci_miss = 0
        self.phich_err = 0
        for _ in range(-(-n_frames // self.cfg.batch)):
            res = self.step(gen, n0, W)
            errs += res.errs.cpu().numpy()
            reach += res.reach.cpu().numpy()
            self.dci_miss += int(res.dci_miss)
            self.phich_err += int(res.phich_err)
        return errs, reach

    def sweep(self, snrs, n_frames: int, seed: int = 0, verbose: bool = True,
              early_exit: bool = True):
        """SNR sweep; rows of (snr, errs [R], trials [R], bler [R])."""
        rows = []
        for s in snrs:
            errs, reach = self.run_snr(float(s), n_frames, seed)
            bler = errs / np.maximum(reach, 1)
            rows.append((float(s), errs.copy(), reach.copy(), bler.copy()))
            if verbose:
                txt = " ".join(f"r{r}:{bler[r]:.3f}({errs[r]}/{reach[r]})"
                               for r in range(len(bler)))
                print(f"SNR {s:+6.2f} dB: {txt} dci_miss:{self.dci_miss} "
                      f"phich_err:{self.phich_err}", flush=True)
            if early_exit and errs[-1] == 0:
                break
        return rows
